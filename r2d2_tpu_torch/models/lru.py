"""The linear recurrent core, LRU (port of r2d2_tpu/models/lru.py).

A diagonal linear complex recurrence per hidden unit,

    h_t = lambda * h_{t-1} + gamma * (B x_t)        (elementwise in C^H)

with lambda = exp(-exp(nu_log) + i exp(theta_log)), so |lambda| < 1, and
gamma = sqrt(max(1 - |lambda|^2, 1e-8)); then a nonlinear readout plus an
input skip: gelu(Re(h C)) + x @ skip, with flax's tanh-approximated gelu.
Complex math is spelled out over (re, im) pairs of real tensors.

The carry is a pair of (B, H) real tensors (Re h, Im h), so it rides the
same stored (B, 2, H) hidden field as the LSTM's (h, c).

Two unroll forms of the same recurrence, chosen by `chunk`:

- 0: all T states by one log-depth associative scan over time
  (:func:`associative_scan`, the recursion of ``jax.lax.associative_scan``:
  pairs combined, the half-length scan, then the even positions), about
  2 log2(T) sweeps;
- C > 0: per chunk of C steps a causal triangular matmul against the
  powers of lambda, and a sequential carry over the T/C chunk-final states;
  T is zero-padded up to a multiple of C.

The recurrence, the scan and the chunk products run in float32 (the card
runs them with TF32 off: ``config.set_fp32_numerics``); the input
projection and the readout in the compute dtype `dtype`, with the float32
parameters cast to it where they are used. The LRU has no hand-written
kernel: the JAX package's is XLA code, and so is this one's.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Carry = Tuple[torch.Tensor, torch.Tensor]  # (re, im), each (B, H) float32
Elems = Sequence[torch.Tensor]


def _combine(e1: Elems, e2: Elems) -> List[torch.Tensor]:
    """(a1, b1) o (a2, b2) = (a2 a1, a2 b1 + b2) over complex (re, im)
    pairs: the composition of h -> a1 h + b1, then h -> a2 h + b2."""
    a1r, a1i, b1r, b1i = e1
    a2r, a2i, b2r, b2i = e2
    return [
        a2r * a1r - a2i * a1i,
        a2r * a1i + a2i * a1r,
        a2r * b1r - a2i * b1i + b2r,
        a2r * b1i + a2i * b1r + b2i,
    ]


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along `dim`; `even` may be one
    longer than `odd`."""
    n = even.shape[dim] + odd.shape[dim]
    if odd.shape[dim] < even.shape[dim]:
        odd = torch.cat([odd, even.narrow(dim, 0, 1)], dim)
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1).narrow(dim, 0, n)


def associative_scan(elems: Elems, dim: int = 1) -> List[torch.Tensor]:
    """Inclusive prefix of the elements under :func:`_combine` along `dim`,
    in O(log n) sweeps (the recursion ``jax.lax.associative_scan`` runs).
    The elements broadcast against each other in the combine, so lambda's
    part can stay (1, T, H) beside the (B, T, H) inputs."""
    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)

    def part(e, start, stop=None):
        """e[start:stop:2] along `dim` (a view)."""
        return e[(slice(None),) * dim + (slice(start, stop, 2),)]

    # combine adjacent pairs, scan the half-length sequence, then fill in
    # the even positions from the odd prefixes
    reduced = _combine([part(e, 0, n - 1) for e in elems], [part(e, 1) for e in elems])
    odd = associative_scan(reduced, dim)
    if n % 2 == 0:
        even = _combine([o.narrow(dim, 0, o.shape[dim] - 1) for o in odd],
                        [part(e, 2) for e in elems])
    else:
        even = _combine(odd, [part(e, 2) for e in elems])
    # the first prefix is the first element
    even = [torch.cat([e.narrow(dim, 0, 1), r], dim) for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _uniform(shape, scale: float, generator) -> nn.Parameter:
    t = torch.empty(shape)
    with torch.no_grad():
        t.uniform_(-scale, scale, generator=generator)
    return nn.Parameter(t)


class LRU(nn.Module):
    def __init__(self, hidden_dim: int, in_dim: int, dtype: torch.dtype = torch.float32,
                 r_min: float = 0.9, r_max: float = 0.999, max_phase: float = 6.283,
                 chunk: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        H, D = hidden_dim, in_dim
        self.hidden_dim, self.in_dim = H, D
        self.dtype = dtype
        self.chunk = chunk
        with torch.no_grad():
            # |lambda| = exp(-exp(nu_log)) ~ U(r_min, r_max)
            r = r_min + (r_max - r_min) * torch.rand(H, generator=generator)
            self.nu_log = nn.Parameter(torch.log(-torch.log(r)))
            # theta = exp(theta_log) ~ U(1e-4 max_phase, max_phase)
            u = torch.empty(H).uniform_(1e-4, 1.0, generator=generator)
            self.theta_log = nn.Parameter(torch.log(u * max_phase))
        s_in, s_h = 1.0 / math.sqrt(D), 1.0 / math.sqrt(H)
        self.in_re = _uniform((D, H), s_in, generator)
        self.in_im = _uniform((D, H), s_in, generator)
        self.out_re = _uniform((H, H), s_h, generator)
        self.out_im = _uniform((H, H), s_h, generator)
        self.skip = _uniform((D, H), s_in, generator)

    def _polar(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(|lambda|, arg lambda), each (H,)."""
        return torch.exp(-torch.exp(self.nu_log)), torch.exp(self.theta_log)

    def _decay(self):
        mod, theta = self._polar()
        gamma = torch.sqrt(torch.clamp(1.0 - mod * mod, min=1e-8))
        return mod * torch.cos(theta), mod * torch.sin(theta), gamma

    def _project_in(self, xs: torch.Tensor, gamma: torch.Tensor):
        """(..., D) -> the gamma-scaled complex input (re, im), float32."""
        xd = xs.to(self.dtype)
        u_re = (xd @ self.in_re.to(self.dtype)).float()
        u_im = (xd @ self.in_im.to(self.dtype)).float()
        return u_re * gamma, u_im * gamma

    def _readout(self, h_re, h_im, xs) -> torch.Tensor:
        dt = self.dtype
        y = h_re.to(dt) @ self.out_re.to(dt) - h_im.to(dt) @ self.out_im.to(dt)
        return F.gelu(y, approximate="tanh") + xs.to(dt) @ self.skip.to(dt)

    def _scan_states(self, u_re, u_im, carry: Carry):
        """All T states: the prefix (A_t, B_t) of the elements (lambda,
        u_t) gives h_t = A_t h0 + B_t."""
        T, H = u_re.shape[1], u_re.shape[2]
        lam_re, lam_im, _ = self._decay()
        a_re = lam_re.expand(1, T, H)
        a_im = lam_im.expand(1, T, H)
        A_re, A_im, B_re, B_im = associative_scan((a_re, a_im, u_re, u_im), dim=1)
        h0_re = carry[0].float()[:, None]
        h0_im = carry[1].float()[:, None]
        h_re = A_re * h0_re - A_im * h0_im + B_re
        h_im = A_re * h0_im + A_im * h0_re + B_im
        return h_re, h_im

    def _chunked_states(self, u_re, u_im, carry: Carry):
        """All T states by per-chunk causal triangular matmuls and a carry
        over the chunk-final states."""
        C = self.chunk
        B, T, H = u_re.shape
        pad = (C - T % C) % C
        if pad:
            u_re = F.pad(u_re, (0, 0, 0, pad))
            u_im = F.pad(u_im, (0, 0, 0, pad))
        Nc = (T + pad) // C

        # lambda^d for d = 0..C, in polar form
        mod, theta = self._polar()
        d = torch.arange(C + 1, dtype=torch.float32, device=mod.device)[:, None]
        P_re = (mod ** d) * torch.cos(theta * d)  # (C+1, H)
        P_im = (mod ** d) * torch.sin(theta * d)
        i = torch.arange(C, device=mod.device)
        dm = i[:, None] - i[None, :]
        causal = (dm >= 0)[:, :, None]
        dm = torch.where(dm >= 0, dm, 0)
        T_re = torch.where(causal, P_re[dm], 0.0)  # (C, C, H)
        T_im = torch.where(causal, P_im[dm], 0.0)

        ur = u_re.reshape(B, Nc, C, H)
        ui = u_im.reshape(B, Nc, C, H)
        # within-chunk prefix W_t = sum_{s<=t} lambda^(t-s) u_s
        mm = lambda a, b: torch.einsum("tsh,bnsh->bnth", a, b)  # noqa: E731
        Wr = mm(T_re, ur) - mm(T_im, ui)
        Wi = mm(T_re, ui) + mm(T_im, ur)

        # the carry into each chunk: c_n = lambda^C c_{n-1} + W_last(n)
        lamC_re, lamC_im = P_re[C], P_im[C]
        cr, ci = carry[0].float(), carry[1].float()
        ins_re, ins_im = [], []
        for n in range(Nc):
            ins_re.append(cr)
            ins_im.append(ci)
            wr, wi = Wr[:, n, -1], Wi[:, n, -1]
            cr, ci = lamC_re * cr - lamC_im * ci + wr, lamC_re * ci + lamC_im * cr + wi
        pr = torch.stack(ins_re, 1)[:, :, None]  # (B, Nc, 1, H)
        pi = torch.stack(ins_im, 1)[:, :, None]
        # h at offset t of chunk n: W_t + lambda^(t+1) * carry_in(n)
        Q_re, Q_im = P_re[1:], P_im[1:]  # (C, H)
        hr = Wr + Q_re * pr - Q_im * pi
        hi = Wi + Q_re * pi + Q_im * pr
        return hr.reshape(B, T + pad, H)[:, :T], hi.reshape(B, T + pad, H)[:, :T]

    def forward(self, xs: torch.Tensor, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        """Unroll (B, T, D) from `carry`: ((B, T, H) in the compute dtype,
        the final (re, im) carry in float32). The gradient runs through
        every step."""
        _, _, gamma = self._decay()
        u_re, u_im = self._project_in(xs, gamma)
        if self.chunk > 0:
            h_re, h_im = self._chunked_states(u_re, u_im, carry)
        else:
            h_re, h_im = self._scan_states(u_re, u_im, carry)
        return self._readout(h_re, h_im, xs), (h_re[:, -1], h_im[:, -1])

    def step(self, x: torch.Tensor, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        """One acting step on (B, D): one elementwise complex multiply-add."""
        lam_re, lam_im, gamma = self._decay()
        u_re, u_im = self._project_in(x, gamma)
        h_re, h_im = carry[0].float(), carry[1].float()
        new_re = lam_re * h_re - lam_im * h_im + u_re
        new_im = lam_re * h_im + lam_im * h_re + u_im
        return self._readout(new_re, new_im, x), (new_re, new_im)
