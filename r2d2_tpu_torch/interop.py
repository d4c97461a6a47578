"""Parameter conversion between the JAX package's flax tree and the port.

The flax tree arrives as nested dicts of numpy arrays (``{"params": {...}}``
or the inner dict), so nothing here imports JAX. Conversions:

- Dense kernel (in, out)  <->  Linear weight (out, in)
- Conv kernel HWIO        <->  Conv2d weight OIHW
- the LSTM's wi / wh / b keep their layout.

Both directions copy, and the round trip flax -> torch -> flax is bitwise.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_HEADS = ("adv_hidden", "adv_out", "val_hidden", "val_out")


def _enc_names(enc_tree_or_sd, from_flax: bool):
    """(flax module name, port prefix, kind) for every encoder layer."""
    if from_flax:
        names = list(enc_tree_or_sd)
    else:
        names = []
        for k in enc_tree_or_sd:
            if k.startswith("enc.convs.") and k.endswith(".weight"):
                names.append(f"Conv_{k.split('.')[2]}")
            if k.startswith("enc.tail.dense.") and k.endswith(".weight"):
                names.append(f"Dense_{k.split('.')[3]}")
    out = []
    for name in names:
        kind, idx = name.split("_")
        prefix = f"enc.convs.{idx}" if kind == "Conv" else f"enc.tail.dense.{idx}"
        out.append((name, prefix, kind))
    return out


def _to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax parameter tree -> the port's state_dict (CPU tensors)."""
    p = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    for name, prefix, kind in _enc_names(p["enc"], from_flax=True):
        k = np.asarray(p["enc"][name]["kernel"])
        w = k.transpose(3, 2, 0, 1) if kind == "Conv" else k.T
        sd[f"{prefix}.weight"] = _to_torch(w)
        sd[f"{prefix}.bias"] = _to_torch(p["enc"][name]["bias"])
    for n in ("wi", "wh", "b"):
        sd[f"core.{n}"] = _to_torch(p["core"][n])
    for head in _HEADS:
        sd[f"{head}.weight"] = _to_torch(np.asarray(p[head]["kernel"]).T)
        sd[f"{head}.bias"] = _to_torch(p[head]["bias"])
    return sd


def params_to_flax(params) -> dict:
    """The port's state_dict (or module) -> ``{"params": {...}}`` of numpy."""
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    enc = {}
    for name, prefix, kind in _enc_names(sd, from_flax=False):
        w = sd[f"{prefix}.weight"]
        k = w.transpose(2, 3, 1, 0) if kind == "Conv" else w.T
        enc[name] = {"kernel": np.array(k), "bias": np.array(sd[f"{prefix}.bias"])}
    out = {"enc": enc, "core": {n: np.array(sd[f"core.{n}"]) for n in ("wi", "wh", "b")}}
    for head in _HEADS:
        out[head] = {
            "kernel": np.array(sd[f"{head}.weight"].T),
            "bias": np.array(sd[f"{head}.bias"]),
        }
    return {"params": out}
