"""Per-output-channel symmetric int8 weights for the serving plane (port of
r2d2_tpu/ops/quantize.py).

Each selected weight of the network's parameter dict (a state_dict: name
-> tensor) is replaced by an int8 tensor and a float32 scale per output
channel:

    scale_j = max_i |w_ij| / 127        (1.0 where the channel is all zero)
    q_ij    = round(w_ij / scale_j)     clipped to [-127, 127]

and the serve step dequantizes it (``q.float() * scale``) right before
use. Selected: every floating weight of rank >= 2 outside the recurrent
core, that is the encoder's convolutions and dense layers and the
dueling head's kernels. Left as they are: the core (``core.*``: the
LSTM's wi, wh and b, the LRU's parameters), whose sequential carry
compounds a per-step error, and every leaf of rank below 2.

Layout: flax keeps kernels as (in, out) and HWIO, so its output channel is
the last axis; PyTorch keeps (out, in) and OIHW, so here it is axis 0 and
a scale has shape (out, 1, ...). torch.round and jnp.round both round half
to even, and the division is the same IEEE float32 division, so q8 and
scale equal the JAX package's bit for bit after the layout transpose
(tests/test_torch_quantize.py).

Quantization runs on the host side of a publish (serve/server.py), never
in training. Q values drift by a bounded amount against the float arm;
actions may differ only where a Q gap lies inside that drift.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

# parameter-name prefixes whose leaves stay at full precision
_SKIP_PREFIXES = ("core.",)
_Q8_KEYS = frozenset(("q8", "scale"))


def is_qleaf(node) -> bool:
    return isinstance(node, Mapping) and set(node.keys()) == _Q8_KEYS


def _quantize_leaf(w: torch.Tensor) -> dict:
    w32 = w.float()
    dims = tuple(range(1, w32.dim()))
    absmax = w32.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q8": q, "scale": scale}


def quantize_tree(params: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, object], int]:
    """(the dict with every selected weight as {"q8", "scale"}, the number
    quantized); other entries pass through as they are."""
    out: Dict[str, object] = {}
    count = 0
    for name, w in params.items():
        if (not name.startswith(_SKIP_PREFIXES) and w.dim() >= 2
                and torch.is_floating_point(w)):
            out[name] = _quantize_leaf(w)
            count += 1
        else:
            out[name] = w
    return out, count


def dequantize_tree(params: Mapping[str, object],
                    dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Inverse of quantize_tree, within the quantization error: q8 * scale
    in `dtype`. A dict without quantized entries passes through."""
    return {name: (v["q8"].to(dtype) * v["scale"].to(dtype)).to(dtype) if is_qleaf(v) else v
            for name, v in params.items()}
