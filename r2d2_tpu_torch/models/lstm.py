"""The LSTM core (port of r2d2_tpu/models/lstm.py).

Not ``nn.LSTM``: the parameters keep the JAX package's layout — ``wi``
(D, 4H), ``wh`` (H, 4H) and a single bias ``b`` (4H,), gates in i, f, g, o
order, all drawn from uniform(-1/sqrt(H), 1/sqrt(H)).

The input projection x @ wi + b for every step is one large matmul; the
recurrence then runs through ops/lstm_kernel.py: the hand-written kernels
on a CUDA device, their plain versions on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from r2d2_tpu_torch.ops.lstm_kernel import _split_gates, lstm_seq_unroll

Carry = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each (B, H)


class LSTM(nn.Module):
    def __init__(self, hidden_dim: int, in_dim: int, generator=None):
        super().__init__()
        H = hidden_dim
        self.hidden_dim = H
        scale = 1.0 / H ** 0.5

        def uniform(*shape):
            t = torch.empty(shape)
            with torch.no_grad():
                t.uniform_(-scale, scale, generator=generator)
            return nn.Parameter(t)

        self.wi = uniform(in_dim, 4 * H)
        self.wh = uniform(H, 4 * H)
        self.b = uniform(4 * H)

    def _gates(self, proj, h, c):
        z = proj + h @ self.wh
        i, f, g, o = _split_gates(z, self.hidden_dim)
        c_new = f * c + i * g
        return o * torch.tanh(c_new), c_new

    def forward(
        self, xs: torch.Tensor, carry: Carry, burn_in: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Carry]:
        """Unroll (B, T, D) inputs from `carry`; returns (B, T, H) + carry.

        With `burn_in` (B,) the unroll places a per-row stop-gradient seam
        at step burn_in[b] (the fused sequence op). Without it the gradient
        runs through every step, which on the card needs the seamless
        backward kernel (K3), not yet ported."""
        B, T, D = xs.shape
        h, c = carry
        proj = (xs.reshape(B * T, D) @ self.wi + self.b).reshape(B, T, -1)
        proj_t = proj.transpose(0, 1).contiguous()  # (T, B, 4H) time-major
        if burn_in is not None:
            outs_t, (hT, cT) = lstm_seq_unroll(
                proj_t, self.wh, h.contiguous(), c.contiguous(), burn_in.to(torch.int32)
            )
            return outs_t.transpose(0, 1), (hT, cT)
        if xs.device.type == "cuda":
            raise NotImplementedError(
                "the LSTM unroll without the burn-in seam (fused_sequence="
                "False) needs the seamless backward kernel K3, which is "
                "queued (ROADMAP.md Queue 2)"
            )
        outs = []
        for t in range(T):
            h, c = self._gates(proj_t[t], h, c)
            outs.append(h)
        return torch.stack(outs, dim=1), (h, c)

    def step(self, x: torch.Tensor, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        """Single acting step on (B, D) input."""
        h, c = carry
        h_new, c_new = self._gates(x @ self.wi + self.b, h, c)
        return h_new, (h_new, c_new)
