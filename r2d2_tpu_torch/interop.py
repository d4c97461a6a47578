"""Parameter conversion between the JAX package's flax tree and the port.

The flax tree arrives as nested dicts of numpy arrays (``{"params": {...}}``
or the inner dict), so nothing here imports JAX. Conversions:

- Dense kernel (in, out)  <->  Linear weight (out, in)
- Conv kernel HWIO        <->  Conv2d weight OIHW
- the encoder's flax names in creation order: ``Conv_i`` -> ``enc.convs.i``,
  ``Dense_i`` -> ``enc.tail.dense.i``, and the IMPALA encoder's
  ``ResidualBlock_j/Conv_k`` -> ``enc.blocks.j.convs.k``;
- the core's parameters keep their names and layouts: the LSTM's wi / wh /
  b, the LRU's nu_log, theta_log, in_re, in_im, out_re, out_im, skip.

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


def _prefix(path) -> str:
    """The port's prefix of the encoder layer at flax path `path` (under
    "enc")."""
    idx = [name.split("_")[1] for name in path]
    if path[0].startswith("ResidualBlock_"):
        return f"enc.blocks.{idx[0]}.convs.{idx[1]}"
    return f"enc.convs.{idx[0]}" if path[0].startswith("Conv_") else f"enc.tail.dense.{idx[0]}"


def _flax_path(key: str):
    """The flax path (under "enc") of the port's encoder weight `key`; None
    for any other key."""
    parts = key.split(".")
    if parts[0] != "enc" or parts[-1] != "weight":
        return None
    if parts[1] == "convs":
        return (f"Conv_{parts[2]}",)
    if parts[1] == "blocks":
        return (f"ResidualBlock_{parts[2]}", f"Conv_{parts[4]}")
    return (f"Dense_{parts[3]}",)


def _is_conv(path) -> bool:
    return path[-1].startswith("Conv_")


def _flax_layers(enc: Mapping):
    """The paths of the layers (dicts holding a kernel) in a flax encoder tree."""
    for name, sub in enc.items():
        if "kernel" in sub:
            yield (name,)
        else:
            yield from ((name, inner) for inner in sub)


def _at(tree: Mapping, path):
    for key in path:
        tree = tree[key]
    return tree


def _to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def encoder_from_flax(enc: Mapping) -> Dict[str, torch.Tensor]:
    """A flax encoder tree (the network's "enc") -> the port's encoder
    entries, keyed as in the network's state_dict ("enc.")."""
    sd: Dict[str, torch.Tensor] = {}
    for path in _flax_layers(enc):
        layer, prefix = _at(enc, path), _prefix(path)
        k = np.asarray(layer["kernel"])
        w = k.transpose(3, 2, 0, 1) if _is_conv(path) else k.T
        sd[f"{prefix}.weight"] = _to_torch(w)
        sd[f"{prefix}.bias"] = _to_torch(layer["bias"])
    return sd


def encoder_to_flax(sd: Mapping) -> dict:
    """The port's "enc." state_dict entries (CPU tensors or numpy) -> the
    flax encoder tree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    enc: dict = {}
    for path in filter(None, map(_flax_path, sd)):
        prefix = _prefix(path)
        w = sd[f"{prefix}.weight"]
        k = w.transpose(2, 3, 1, 0) if _is_conv(path) else w.T
        parent = enc
        for key in path[:-1]:
            parent = parent.setdefault(key, {})
        parent[path[-1]] = {"kernel": np.array(k), "bias": np.array(sd[f"{prefix}.bias"])}
    return enc


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax parameter tree -> the port's state_dict (CPU tensors)."""
    p = tree.get("params", tree)
    sd = encoder_from_flax(p["enc"])
    for n in p["core"]:
        sd[f"core.{n}"] = _to_torch(p["core"][n])
    for head in _HEADS:
        sd[f"{head}.weight"] = _to_torch(np.asarray(p[head]["kernel"]).T)
        sd[f"{head}.bias"] = _to_torch(p[head]["bias"])
    return sd


def params_to_flax(params) -> dict:
    """The port's state_dict (or module) -> ``{"params": {...}}`` of numpy."""
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    enc = encoder_to_flax(sd)
    core = {k[len("core."):]: np.array(v) for k, v in sd.items() if k.startswith("core.")}
    out = {"enc": enc, "core": core}
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
