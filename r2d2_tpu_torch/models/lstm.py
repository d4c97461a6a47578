"""The LSTM core (port of r2d2_tpu/models/lstm.py).

Not ``nn.LSTM``: the parameters keep the JAX package's layout — ``wi``
(D, 4H), ``wh`` (H, 4H) and a single bias ``b`` (4H,), gates in i, f, g, o
order, all drawn from uniform(-1/sqrt(H), 1/sqrt(H)).

The input projection x @ wi + b for every step is one large matmul; the
recurrence then runs through ops/lstm_kernel.py: the hand-written kernels
on a CUDA device, their plain versions on the CPU.

The kernels copy rows 16 bytes at a time, so on the card a hidden size that
is not a multiple of 4 (float32) or 8 (bfloat16) values is padded with zero
units, gate block by gate block (:func:`pad_units`), and the outputs are
sliced back to H. A zero unit stays exactly zero (its gates are all 0, so
c = sigmoid(0)*0 + sigmoid(0)*tanh(0) = 0 and h = sigmoid(0)*tanh(0) = 0),
and adds only zero products to the real units in both directions, so the
real units change only by summation order.

`dtype` is the compute dtype, as the flax module's: the parameters stay
float32 and are cast to it where they are used, with the inputs and the
incoming carry (``r2d2_tpu/models/lstm.py:121-124``); the input projection
runs in it, and so does the acting step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from r2d2_tpu_torch.ops.lstm_kernel import (
    _split_gates,
    lstm_seq_unroll,
    lstm_seq_unroll_ckpt,
    lstm_seq_unroll_fused_dwh,
    lstm_unroll,
)

Carry = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each (B, H)


def kernel_row(dtype: torch.dtype) -> int:
    """Values of `dtype` in one 16-byte copy: the kernels' multiple of H."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def pad_units(wi, wh, b, h, c, Hp: int):
    """(wi, wh, b, h, c) at hidden size H grown to Hp with zero units: zero
    columns at the end of each of the four gate blocks of wi, wh and b,
    zero rows of wh, zero columns of h and c. Differentiable: the padding's
    gradient is dropped."""
    D, H = wi.shape[0], wh.shape[0]
    p = Hp - H
    wi = F.pad(wi.reshape(D, 4, H), (0, p)).reshape(D, 4 * Hp)
    b = F.pad(b.reshape(4, H), (0, p)).reshape(4 * Hp)
    wh = F.pad(F.pad(wh.reshape(H, 4, H), (0, p)).reshape(H, 4 * Hp), (0, 0, 0, p))
    return wi, wh, b, F.pad(h, (0, p)), F.pad(c, (0, p))


class LSTM(nn.Module):
    def __init__(self, hidden_dim: int, in_dim: int, generator=None,
                 backward_arm: Tuple[str, int] = ("default", 0),
                 dtype: torch.dtype = torch.float32):
        """`backward_arm` is the resolved (arm, ckpt_stride) of
        ``R2D2Config.resolve_backward_arm``: which backward the unroll with
        a seam runs. `dtype` is the compute dtype."""
        super().__init__()
        H = hidden_dim
        self.hidden_dim = H
        self.backward_arm = tuple(backward_arm)
        self.dtype = dtype
        scale = 1.0 / H ** 0.5

        def uniform(*shape):
            t = torch.empty(shape)
            with torch.no_grad():
                t.uniform_(-scale, scale, generator=generator)
            return nn.Parameter(t)

        self.wi = uniform(in_dim, 4 * H)
        self.wh = uniform(H, 4 * H)
        self.b = uniform(4 * H)

    def _params(self):
        """(wi, wh, b) in the compute dtype."""
        return tuple(p.to(self.dtype) for p in (self.wi, self.wh, self.b))

    def padded_units(self, device) -> int:
        """The hidden size the unroll runs at on `device`: H rounded up to
        the kernels' row on a CUDA device, H itself on the CPU."""
        m = kernel_row(self.dtype) if torch.device(device).type == "cuda" else 1
        return -(-self.hidden_dim // m) * m

    def forward(
        self, xs: torch.Tensor, carry: Carry, burn_in: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Carry]:
        """Unroll (B, T, D) inputs from `carry`; returns (B, T, H) + carry.

        With `burn_in` (B,) the unroll places a per-row stop-gradient seam
        at step burn_in[b] and runs the backward arm the core was built
        with; without it the gradient runs through every step (the seamless
        backward). The op is chosen as the JAX ``LSTM.__call__`` chooses."""
        B, T, D = xs.shape
        H, Hp = self.hidden_dim, self.padded_units(xs.device)
        wi, wh, b = self._params()
        xs = xs.to(self.dtype)
        h, c = (x.to(self.dtype) for x in carry)
        if Hp != H:
            wi, wh, b, h, c = pad_units(wi, wh, b, h, c, Hp)
        h, c = h.contiguous(), c.contiguous()
        proj = (xs.reshape(B * T, D) @ wi + b).reshape(B, T, -1)
        proj_t = proj.transpose(0, 1).contiguous()  # (T, B, 4H) time-major
        arm, stride = self.backward_arm
        if burn_in is None:
            outs_t, (hT, cT) = lstm_unroll(proj_t, wh, h, c)
        else:
            burn_in = burn_in.to(torch.int32)
            if arm == "ckpt":
                unroll = lstm_seq_unroll_ckpt(stride)
            elif arm == "fused_dwh":
                unroll = lstm_seq_unroll_fused_dwh
            else:
                unroll = lstm_seq_unroll
            outs_t, (hT, cT) = unroll(proj_t, wh, h, c, burn_in)
        outs = outs_t.transpose(0, 1)
        if Hp != H:
            outs, hT, cT = outs[..., :H], hT[:, :H], cT[:, :H]
        return outs, (hT.to(self.dtype), cT.to(self.dtype))

    def step(self, x: torch.Tensor, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        """Single acting step on (B, D) input, all in the compute dtype (the
        flax module's ``step`` and ``_gates``)."""
        wi, wh, b = self._params()
        h, c = (v.to(self.dtype) for v in carry)
        z = (x.to(self.dtype) @ wi + b) + h @ wh
        i, f, g, o = _split_gates(z, self.hidden_dim)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)
