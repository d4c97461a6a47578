"""Per-parameter placement over the (dp, tp, fsdp) mesh from one table of
wildcard name patterns (port of r2d2_tpu/parallel/sharding_map.py).

The table is the JAX package's, over the JAX package's leaf names: a port
parameter's name is mapped to its flax path (``interop.flax_leaf``) and
processed as JAX processes a pytree path (``params.core.wi``,
``opt_state.*.*.mu.params.core.wi``), so the same rules give the same
splits in both packages. A rule's axes name, for each dim of the FLAX leaf,
the mesh axis it splits over; the first match wins and anything unmatched
is replicated.

- tp: column-parallel (None, "tp") for the LSTM gate kernels, the encoder's
  Dense_0 and the dueling hiddens (their biases over the split output
  axis), row-parallel ("tp", None) for the head outs, whose biases and
  int8 scales stay replicated; convolutions replicated.
- fsdp: the Adam moments (names holding ``.mu.`` or ``.nu.``) also split
  their first still-unsplit dim that fsdp divides. Parameters stay whole
  over fsdp.

A ``Placement`` is the torch form of a spec: for each mesh axis the port
tensor's dim it splits (a Linear weight is a transposed Dense kernel, a
Conv2d weight the OIHW of an HWIO kernel), and ``shard`` gives the slice a
mesh coordinate holds: contiguous pieces, piece k at coordinate k.

Snapshots record (plane, dp, tp, process_count), never fsdp: fsdp places
state, not the replay layout, so changing --fsdp across --resume never
raises TopologyMismatch.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from r2d2_tpu_torch.interop import flax_leaf
from r2d2_tpu_torch.parallel.mesh import Mesh

# (pattern, axes), first match wins; the JAX package's table
DEFAULT_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # the row-parallel outs' (1, out) scales have no input dim to split;
    # listed before the kernel* row rule below
    ("*.adv_out.kernel.scale", ()),
    ("*.val_out.kernel.scale", ()),
    # LSTM core: column-parallel gates, the bias over the split 4H axis
    ("*.core.wi", (None, "tp")),
    ("*.core.wh", (None, "tp")),
    ("*.core.b", ("tp",)),
    # encoder Dense_0 (the largest single matmul): column-parallel
    ("*.Dense_0.kernel*", (None, "tp")),
    ("*.Dense_0.bias", ("tp",)),
    # dueling hiddens column-parallel, paired with row-parallel outs
    ("*.adv_hidden.kernel*", (None, "tp")),
    ("*.adv_hidden.bias", ("tp",)),
    ("*.val_hidden.kernel*", (None, "tp")),
    ("*.val_hidden.bias", ("tp",)),
    ("*.adv_out.kernel*", ("tp", None)),
    ("*.val_out.kernel*", ("tp", None)),
)

_MOMENT_MARKERS = (".mu.", ".nu.")
# the names JAX's process_name gives a TrainState's parameter, target and
# Adam-moment leaves (optax's chain: (clip state, adam state) -> mu / nu)
TRAIN_STATE_PREFIXES = {
    "params": "params.params",
    "target_params": "target_params.params",
    "mu": "opt_state.*.*.mu.params",
    "nu": "opt_state.*.*.nu.params",
}


def process_name(key: str, prefix: str = "params") -> str:
    """The JAX package's processed name of port parameter `key` (an int8
    leaf as ``key.q8`` / ``key.scale``) under `prefix`."""
    sub = None
    if key.endswith((".q8", ".scale")):
        key, sub = key.rsplit(".", 1)
    path, _ = flax_leaf(key)
    name = ".".join((prefix, *path))
    return f"{name}.{sub}" if sub else name


def match_axes(name: str, rules: Sequence[Tuple[str, Tuple[Optional[str], ...]]]
               ) -> Tuple[Optional[str], ...]:
    """First-match lookup of a processed name in the rule table."""
    for pattern, axes in rules:
        if fnmatch.fnmatchcase(name, pattern):
            return tuple(axes)
    return ()


def spec_for(name: str, shape: Sequence[int], mesh: Mesh, rules=None) -> Tuple[Optional[str], ...]:
    """The JAX PartitionSpec (as a tuple) of a leaf of flax shape `shape`:
    the table's tp axes, then the fsdp rule for Adam moments. Axes the mesh
    does not carry, and axes past the leaf's rank, are dropped."""
    rules = DEFAULT_RULES if rules is None else rules
    ndim = len(shape)
    axes = [a if (a is None or a in mesh.axis_names) else None
            for a in match_axes(name, rules)][:ndim]
    if mesh.fsdp > 1 and any(m in name for m in _MOMENT_MARKERS):
        axes = axes + [None] * (ndim - len(axes))
        for d in range(ndim):
            if axes[d] is None and shape[d] % mesh.fsdp == 0 and shape[d] > 0:
                axes[d] = "fsdp"
                break
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a port tensor lives on the mesh: `spec` the JAX spec over the
    flax leaf's dims, `dims` (mesh axis, the port tensor's dim it splits)."""

    spec: Tuple[Optional[str], ...]
    dims: Tuple[Tuple[str, int], ...]

    def dim(self, axis: str) -> Optional[int]:
        for a, d in self.dims:
            if a == axis:
                return d
        return None

    def shard(self, t: torch.Tensor, mesh: Mesh, **coord: int) -> torch.Tensor:
        """The slice of `t` the mesh coordinate (tp=..., fsdp=...) holds (a
        view; an axis left out of `coord` is taken whole)."""
        for axis, dim in self.dims:
            if axis not in coord:
                continue
            size = t.shape[dim] // mesh.shape[axis]
            t = t.narrow(dim, coord[axis] * size, size)
        return t


def placement_for(key: str, shape: Sequence[int], mesh: Mesh, prefix: str = "params",
                  rules=None) -> Placement:
    """The Placement of port tensor `key` of shape `shape` (torch layout)
    under `prefix` (a TRAIN_STATE_PREFIXES value, or "params")."""
    base = key.rsplit(".", 1)[0] if key.endswith((".q8", ".scale")) else key
    _, dims = flax_leaf(base)
    dims = dims or tuple(range(len(shape)))
    flax_shape = [0] * len(shape)
    for i, j in enumerate(dims):
        flax_shape[j] = shape[i]
    spec = spec_for(process_name(key, prefix), flax_shape, mesh, rules)
    torch_dims = tuple((a, dims.index(j)) for j, a in enumerate(spec) if a is not None)
    return Placement(spec, torch_dims)


def moment_spec_for(key: str, shape: Sequence[int], mesh: Mesh, rules=None) -> Placement:
    """The Placement of parameter `key`'s Adam mu / nu: its table axes plus
    the fsdp dim. The ZeRO steps hand each fsdp member the gradient slice
    along this dim."""
    return placement_for(key, shape, mesh, TRAIN_STATE_PREFIXES["mu"], rules)


def train_state_shardings(net: torch.nn.Module, mesh: Mesh, rules=None) -> Dict[str, Placement]:
    """The Placement of every leaf of a TrainState over `net`'s parameters:
    ``params.<key>``, ``target_params.<key>``, ``mu.<key>``, ``nu.<key>``."""
    out = {}
    for key, p in net.named_parameters():
        for kind, prefix in TRAIN_STATE_PREFIXES.items():
            out[f"{kind}.{key}"] = placement_for(key, tuple(p.shape), mesh, prefix, rules)
    return out


def serve_param_shardings(params: Mapping[str, object], mesh: Mesh, rules=None
                          ) -> Dict[str, object]:
    """Placements of a serve parameter set (a state_dict, possibly int8:
    a {"q8", "scale"} dict per quantized weight, each following the
    kernel's rules)."""
    out: Dict[str, object] = {}
    for key, v in params.items():
        if isinstance(v, Mapping):
            out[key] = {sub: placement_for(f"{key}.{sub}", tuple(t.shape), mesh, "params", rules)
                        for sub, t in v.items()}
        else:
            out[key] = placement_for(key, tuple(v.shape), mesh, "params", rules)
    return out


def tp_split_leaves(net: torch.nn.Module, mesh: Mesh) -> Dict[str, int]:
    """The parameters tp splits, each with the port tensor's dim it splits
    (empty at tp = 1)."""
    if mesh.tp <= 1:
        return {}
    out = {}
    for key, p in net.named_parameters():
        d = placement_for(key, tuple(p.shape), mesh).dim("tp")
        if d is not None:
            out[key] = d
    return out


class PlacedTensor:
    """A serve tensor held as its tp shards: piece t on the device of mesh
    position (0, t, 0) (one piece where the table replicates it). The serve
    step gathers the pieces back (``gather``) before it computes."""

    def __init__(self, t: torch.Tensor, placement: Placement, mesh: Mesh):
        self.placement = placement
        self.dim = placement.dim("tp")
        if self.dim is None:
            self.pieces = [t.to(mesh.device_at(0))]
        else:
            self.pieces = [placement.shard(t, mesh, tp=i).to(mesh.device_at(0, i))
                           for i in range(mesh.tp)]

    def gather(self, device) -> torch.Tensor:
        if self.dim is None:
            return self.pieces[0].to(device)
        return torch.cat([p.to(device) for p in self.pieces], dim=self.dim)


def place_params(params: Mapping[str, object], mesh: Mesh, rules=None) -> Dict[str, object]:
    """A serve parameter set (int8 dicts included) as PlacedTensors placed
    by serve_param_shardings."""
    plan = serve_param_shardings(params, mesh, rules)
    out: Dict[str, object] = {}
    for key, v in params.items():
        if isinstance(v, Mapping):
            out[key] = {sub: PlacedTensor(t, plan[key][sub], mesh) for sub, t in v.items()}
        else:
            out[key] = PlacedTensor(v, plan[key], mesh)
    return out


def gather_params(placed: Mapping[str, object], device) -> Dict[str, object]:
    """The inverse of place_params: every PlacedTensor whole on `device`."""
    return {k: ({s: t.gather(device) for s, t in v.items()} if isinstance(v, Mapping)
                else v.gather(device)) for k, v in placed.items()}
