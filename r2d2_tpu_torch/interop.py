"""Parameter conversion between the JAX package's flax tree and the port.

The flax tree arrives as nested dicts of numpy arrays (``{"params": {...}}``
or the inner dict), so nothing here imports JAX. Conversions:

- Dense kernel (in, out)  <->  Linear weight (out, in)
- Conv kernel HWIO        <->  Conv2d weight OIHW
- the LSTM's wi / wh / b keep their layout.

Optimizer state: optax's Adam (``ScaleByAdamState``: ``mu`` and ``nu``,
parameter-shaped trees, and ``count``) <-> torch Adam's state_dict
(``exp_avg``, ``exp_avg_sq`` and ``step`` per parameter index). Both count
the updates applied, and both use the count after the increment in the bias
correction, so the next update is the same function of either.

Both directions copy, and the round trips flax -> torch -> flax are bitwise.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Sequence, Tuple

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


def adam_state_from_optax(template: Mapping, names: Sequence[str], mu: Mapping, nu: Mapping,
                          count) -> dict:
    """optax Adam's (mu, nu, count) -> a torch Adam state_dict. `template`
    is the target optimizer's own state_dict (its param_groups are kept);
    `names` are the parameter names in the optimizer's order
    (``[n for n, _ in net.named_parameters()]``)."""
    mu_sd, nu_sd = params_from_flax(mu), params_from_flax(nu)
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    state = {i: {"step": step.clone(), "exp_avg": mu_sd[n], "exp_avg_sq": nu_sd[n]}
             for i, n in enumerate(names)}
    return {"state": state, "param_groups": copy.deepcopy(list(template["param_groups"]))}


def adam_state_to_optax(state_dict: Mapping, names: Sequence[str]) -> Tuple[dict, dict, np.ndarray]:
    """A torch Adam state_dict -> optax Adam's (mu, nu, count) as
    ``{"params": {...}}`` trees of numpy and an int32 count."""
    state = state_dict["state"]
    mu = params_to_flax({n: state[i]["exp_avg"] for i, n in enumerate(names)})
    nu = params_to_flax({n: state[i]["exp_avg_sq"] for i, n in enumerate(names)})
    count = np.asarray(int(state[0]["step"]), np.int32)
    return mu, nu, count
