"""Observation encoders (port of r2d2_tpu/models/encoders.py).

Inputs are NHWC floats in [0, 1], as in the JAX package. Convolutions run
in PyTorch's NCHW layout; the conv trunk's output is permuted back to NHWC
before it is flattened, so ``Dense_0`` sees features in the JAX package's
order (encoders.py:60-63) and converted weights line up.

- NatureEncoder: Conv 32x8x8/4 -> 64x4x4/2 -> 64x3x3/1 (VALID) -> Dense.
- ImpalaEncoder: per channel count, Conv 3x3 (SAME) -> max pool 3x3/2
  (SAME) -> two residual blocks (relu, conv, relu, conv, + skip); relu,
  flatten -> Dense.
- MLPEncoder: flatten -> Dense.
All end in the shared latent tail: Dense_0 + relu, then `depth` extra
Dense(latent) + relu layers.

flax's SAME max pool pads by the input size: the total pad
(out - 1) * stride + window - in, with out = ceil(in / stride), is split
lo = total // 2, hi = total - lo, with -inf (:func:`same_pool_pads`). That
is (0, 1) at 26 -> 13 and 64 -> 32 but (1, 1) at 13 -> 7, so no fixed
padding of ``MaxPool2d`` matches it.

`dtype` is the compute dtype, as flax's ``Dense(dtype=...)`` and
``Conv(dtype=...)`` take it: float32 parameters cast to it where they are
used, the input cast to it, every layer computed in it. Every layer rounds
where flax's does: the product (convolution or matmul) is rounded to the
dtype, then the bias is added and the sum rounded again (flax's
``y = dot(x, w); y += b``). A bias fused into the product would round once,
which in bfloat16 moves outputs by a unit of the last place where flax's
do not (:func:`_conv`, :func:`_linear`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: variance_scaling(1, fan_in,
    truncated_normal) — a normal truncated at two standard deviations,
    rescaled so the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def dense(in_dim: int, out_dim: int, generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    lecun_normal_(layer.weight, in_dim, generator)
    nn.init.zeros_(layer.bias)
    return layer


def conv(in_ch: int, out_ch: int, k: int, stride: int, generator) -> nn.Conv2d:
    """flax's Conv init: lecun normal over in_ch*k*k, zero bias."""
    layer = nn.Conv2d(in_ch, out_ch, k, stride=stride)
    lecun_normal_(layer.weight, in_ch * k * k, generator)
    nn.init.zeros_(layer.bias)
    return layer


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax's Dense(dtype=dtype): the matmul rounded, then the bias added."""
    return F.linear(x, layer.weight.to(dtype)) + layer.bias.to(dtype)


def _conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype,
          padding: int = 0) -> torch.Tensor:
    """flax's Conv(dtype=dtype), NCHW: the convolution rounded, then the
    bias added."""
    y = F.conv2d(x, layer.weight.to(dtype), None, stride=layer.stride, padding=padding)
    return y + layer.bias.to(dtype)[:, None, None]


class _LatentTail(nn.Module):
    def __init__(self, in_dim: int, latent_dim: int, depth: int, generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.ModuleList(
            [dense(in_dim, latent_dim, generator)]
            + [dense(latent_dim, latent_dim, generator) for _ in range(depth)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in self.dense:
            x = F.relu(_linear(x, layer, self.dtype))
        return x


class NatureEncoder(nn.Module):
    def __init__(self, obs_shape: Sequence[int], latent_dim: int = 512,
                 depth: int = 0, generator=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        h, w, c = obs_shape
        self.convs = nn.ModuleList([
            conv(c, 32, 8, 4, generator),
            conv(32, 64, 4, 2, generator),
            conv(64, 64, 3, 1, generator),
        ])
        for k, s in ((8, 4), (4, 2), (3, 1)):
            h, w = (h - k) // s + 1, (w - k) // s + 1
        if h < 1 or w < 1:
            raise ValueError(f"obs {tuple(obs_shape)} is too small for the nature trunk")
        self.tail = _LatentTail(h * w * 64, latent_dim, depth, generator, dtype)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The flat trunk output that Dense_0 takes."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW for the convolutions
        for layer in self.convs:
            x = F.relu(_conv(x, layer, self.dtype))
        # flatten in NHWC order, as the JAX trunk does
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.features(x))


def same_pool_pads(size: int, window: int = 3, stride: int = 2) -> Tuple[int, int]:
    """(lo, hi) padding of flax's SAME pooling along an axis of `size`."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """3x3 stride-1 SAME convolution: symmetric padding of 1."""
    return _conv(x, layer, dtype, padding=1)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax's nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME"), NCHW."""
    (top, bottom), (left, right) = (same_pool_pads(n) for n in x.shape[2:])
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, 3, stride=2)


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, generator=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList([conv(channels, channels, 3, 1, generator)
                                    for _ in range(2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv_same(F.relu(x), self.convs[0], self.dtype)
        y = _conv_same(F.relu(y), self.convs[1], self.dtype)
        return x + y


class ImpalaEncoder(nn.Module):
    """The flax tree's names map onto the modules in creation order: stage
    i's ``Conv_i`` is ``convs[i]``, ``ResidualBlock_j`` is ``blocks[j]``
    (two per stage), ``Dense_k`` is ``tail.dense[k]`` (interop.py)."""

    def __init__(self, obs_shape: Sequence[int], latent_dim: int = 512,
                 channels: Sequence[int] = (16, 32, 32), depth: int = 0, generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        h, w, c = obs_shape
        convs, blocks = [], []
        for ch in channels:
            convs.append(conv(c, ch, 3, 1, generator))
            blocks += [ResidualBlock(ch, generator, dtype) for _ in range(2)]
            c, h, w = ch, -(-h // 2), -(-w // 2)
        self.convs = nn.ModuleList(convs)
        self.blocks = nn.ModuleList(blocks)
        self.tail = _LatentTail(h * w * c, latent_dim, depth, generator, dtype)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The flat trunk output that Dense_0 takes."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW for the convolutions
        for i, layer in enumerate(self.convs):
            x = _max_pool_same(_conv_same(x, layer, self.dtype))
            x = self.blocks[2 * i + 1](self.blocks[2 * i](x))
        # flatten in NHWC order, as the JAX trunk does
        return F.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.features(x))


class MLPEncoder(nn.Module):
    def __init__(self, obs_shape: Sequence[int], latent_dim: int = 32,
                 depth: int = 0, generator=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tail = _LatentTail(math.prod(obs_shape), latent_dim, depth, generator, dtype)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.features(x))


def make_encoder(name: str, obs_shape, latent_dim: int, depth: int = 0, generator=None,
                 dtype: torch.dtype = torch.float32, impala_channels=(16, 32, 32)):
    if name == "nature":
        return NatureEncoder(obs_shape, latent_dim, depth, generator, dtype)
    if name == "impala":
        return ImpalaEncoder(obs_shape, latent_dim, tuple(impala_channels), depth, generator,
                             dtype)
    if name == "mlp":
        return MLPEncoder(obs_shape, latent_dim, depth, generator, dtype)
    raise ValueError(f"unknown encoder {name!r}")
