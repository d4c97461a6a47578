"""A bound on how far two implementations of the IMPALA encoder that round
at the same points can be apart, element by element (the bf16 encoder
against flax's, or the card's cuDNN against the CPU's oneDNN).

Verification code: tests/test_torch_impala_bf16.py holds the port's bf16
encoder against flax's to it, and chip_smoke.py prints the whole bf16
procgen update's priorities beside it. Nothing on a training or serving
path imports this module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .encoders import ImpalaEncoder, _max_pool_same, same_pool_pads


def unit_roundoff(dtype: torch.dtype) -> float:
    """Half a unit of the last place, relative: 2^-8 for bfloat16, 2^-24
    for float32."""
    return torch.finfo(dtype).eps / 2


def _f32_sum_error(n: int) -> float:
    """gamma_n of a float32 sum of n products: its error is at most gamma_n
    times the sum of their absolute values."""
    e = n * unit_roundoff(torch.float32)
    return e / (1.0 - e)


def _spacing(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of `dtype`'s values at magnitude |a| (float32)."""
    fi = torch.finfo(dtype)
    return torch.exp2(torch.floor(torch.log2(a.abs().clamp_min(fi.tiny)))) * fi.eps


def rounding_gap(v: torch.Tensor, d: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Two sides each round to `dtype` a float32 value that lies within d of
    v (element by element): how far apart their results can be. Zero where
    [v - d, v + d] holds no rounding boundary (both round to the value v
    rounds to); 2d plus the spacing at |v| + d where it holds one."""
    r = v.to(dtype).float()
    sp = _spacing(r, dtype)
    below = torch.where(r.abs() == sp / torch.finfo(dtype).eps, sp / 4, sp / 2)
    cross = (v - r).abs() + d >= below
    return torch.where(cross, d + _spacing(v.abs() + d, dtype), torch.zeros_like(d))


def relu_gap(a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """|relu(a) - relu(b)| for any b within e of a."""
    a = a.float()
    return torch.maximum(F.relu(a + e) - F.relu(a), F.relu(a) - F.relu(a - e))


def pool_gap(z: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """|maxpool(a) - maxpool(b)| over flax's SAME 3x3/2 windows (NCHW), for
    any b within e of a = z: max(e at the max m, max_j (a_j + e_j) - m)."""
    (top, bottom), (left, right) = (same_pool_pads(n) for n in z.shape[2:])
    pads = (left, right, top, bottom)
    zf = F.pad(z.float(), pads, value=float("-inf"))
    m, idx = F.max_pool2d(zf, 3, stride=2, return_indices=True)
    ep = F.pad(e, pads)
    e_m = ep.flatten(2).gather(2, idx.flatten(2)).reshape(m.shape)
    reach = F.max_pool2d(zf + ep, 3, stride=2)
    return torch.maximum(e_m, reach - m)


@torch.no_grad()
def impala_rounding_bound(enc: ImpalaEncoder, x: torch.Tensor, trace: Optional[list] = None):
    """The encoder's output on NHWC floats `x`, as ``enc(x)``, and element
    by element a bound on how far from it another implementation can be
    that rounds at the same points in the encoder's dtype and sums every
    product in float32 in its own order: flax's ImpalaEncoder(dtype=...) on
    the same parameters, or this encoder on another device. -> (out,
    bound), both float32.

    The bound E on the two sides' difference starts at 0 (both cast the
    same input) and is carried layer by layer:
    - a product (a convolution of fan-in n = 9 C_in, or a Dense) moves by
      at most |W| * E, and each side's float32 sum lies within gamma_n |W|
      * |x| of the exact one (gamma_n = n 2^-24 / (1 - n 2^-24), the
      accumulation's growth with its fan-in);
    - each rounding point either side takes (the product, the bias add,
      the residual add) leaves 0 where no rounding boundary lies within
      the values' reach, and two reaches plus one unit of the last place
      where one does (rounding_gap): one unit per rounding point that
      either side can take;
    - a max pool and a relu pass on the largest move their outputs can
      make (pool_gap, relu_gap).

    `trace`, when given, receives one dict per stage and one for the
    latent tail, with every value and bound the backward's bound needs
    (tests/test_torch_impala_bf16.py)."""
    dt = enc.dtype

    def product(v, e, w, fn):
        """(the port's rounded product, its bound) of fn(v, w)."""
        w2 = w.float().square()
        g = _f32_sum_error(w[0].numel())
        reach = fn(e.square(), w2).sqrt()
        d = reach * (1 + g) + 3 * g * fn(v.float().square(), w2).sqrt()
        return fn(v, w), rounding_gap(fn(v.float(), w.float()), d, dt)

    def biased(y, ey, bias):
        z = y + bias
        return z, rounding_gap(y.float() + bias.float(), ey, dt)

    def conv(v, e, layer):
        y, ey = product(v, e, layer.weight.to(dt), lambda a, w: F.conv2d(a, w, padding=1))
        return biased(y, ey, layer.bias.to(dt)[:, None, None])

    v = x.to(dt).permute(0, 3, 1, 2)
    e = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for i, layer in enumerate(enc.convs):
        stage = {"x": v, "e_x": e, "layer": layer}
        z, ez = conv(v, e, layer)
        stage.update(z=z, e_z=ez, blocks=[])
        v, e = _max_pool_same(z), pool_gap(z, ez)
        for block in enc.blocks[2 * i:2 * i + 2]:
            a, ea = conv(F.relu(v), relu_gap(v, e), block.convs[0])
            b, eb = conv(F.relu(a), relu_gap(a, ea), block.convs[1])
            stage["blocks"].append({"x": v, "e_x": e, "a": a, "e_a": ea, "block": block})
            v, e = v + b, rounding_gap(v.float() + b.float(), e + eb, dt)
        if trace is not None:
            trace.append(stage)
    tail = {"pre": v, "e_pre": e, "layers": []}
    e = relu_gap(v, e).permute(0, 2, 3, 1).reshape(v.shape[0], -1)
    v = F.relu(v).permute(0, 2, 3, 1).reshape(v.shape[0], -1)
    for layer in enc.tail.dense:
        y, ey = product(v, e, layer.weight.to(dt), lambda a, w: a @ w.T)
        z, ez = biased(y, ey, layer.bias.to(dt))
        tail["layers"].append({"x": v, "e_x": e, "layer": layer, "z": z, "e_z": ez})
        v, e = F.relu(z), relu_gap(z, ez)
    if trace is not None:
        trace.append(tail)
    return v.float(), e
