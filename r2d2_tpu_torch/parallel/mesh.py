"""The (dp, tp, fsdp) mesh (port of r2d2_tpu/parallel/mesh.py).

A ``Mesh`` names the device of every mesh position, ``grid[d][t][f]``, and
the process that owns each dp shard. The JAX package reshapes
``jax.devices()`` into a named mesh and shards arrays over it; here a dp
shard's store, its batch rows and the network replica that differentiates
them live on ``mesh.devices[d]`` (its position (d, 0, 0)); a tp member's
parameter slices on its position's device; an fsdp member's Adam moment
shards on (0, 0, f)'s. Devices may repeat: ``["cuda:0"] * 4`` runs four
shards on one card, and ``["cpu"] * 4`` runs them on the CPU (torch has no
fake devices, where the JAX tests get eight from ``XLA_FLAGS``).
Repetition changes where a shard runs, never what it computes.

Axis names follow the JAX mesh: ("dp", "tp"), and ("dp", "tp", "fsdp")
when fsdp > 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    # the device of each dp shard (its position (d, 0, 0)), as its owning
    # process addresses it
    devices: Tuple[torch.device, ...]
    # the rank of the process that owns each shard (all 0 in one process)
    processes: Tuple[int, ...]
    tp: int = 1
    fsdp: int = 1
    # every position's device, flattened in (dp, tp, fsdp) order; empty
    # means tp = fsdp = 1 (grid = devices)
    positions: Tuple[torch.device, ...] = ()

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("dp", "tp", "fsdp") if self.fsdp > 1 else ("dp", "tp")

    @property
    def shape(self) -> Dict[str, int]:
        out = {"dp": self.dp, "tp": self.tp}
        if self.fsdp > 1:
            out["fsdp"] = self.fsdp
        return out

    def device_at(self, d: int, t: int = 0, f: int = 0) -> torch.device:
        """The device of mesh position (d, t, f)."""
        if not self.positions:
            return self.devices[d]
        return self.positions[(d * self.tp + t) * self.fsdp + f]

    def tp_devices(self, d: int, f: int = 0) -> List[torch.device]:
        """The tp group of batch shard (d, f): its members' devices."""
        return [self.device_at(d, t, f) for t in range(self.tp)]

    def fsdp_devices(self) -> List[torch.device]:
        """The fsdp members' devices (positions (0, 0, f)), where the Adam
        moment shards live."""
        return [self.device_at(0, 0, f) for f in range(self.fsdp)]


def parse_devices(spec: Union[str, torch.device, Sequence]) -> List[torch.device]:
    """Devices from a comma-separated string ("cuda:0,cuda:0"), one device,
    or a sequence of either."""
    if isinstance(spec, torch.device):
        return [spec]
    if isinstance(spec, str):
        spec = [s for s in spec.split(",") if s.strip()]
    return [torch.device(str(d).strip()) if not isinstance(d, torch.device) else d
            for d in spec]


def make_mesh(dp: Optional[int] = None, devices: Optional[Sequence] = None,
              tp: int = 1, fsdp: int = 1) -> Mesh:
    """A one-process (dp, tp, fsdp) mesh. With no devices: cuda:0 ..
    cuda:n-1 for the n = dp*tp*fsdp positions, which raises when fewer
    cards are visible (dp defaults to the visible count over tp*fsdp).
    Explicit devices, in (dp, tp, fsdp) order, may repeat; their count must
    be dp*tp*fsdp."""
    from r2d2_tpu_torch.config import resolve_device

    if tp < 1 or fsdp < 1:
        raise ValueError(f"tp and fsdp must be >= 1, got tp={tp} fsdp={fsdp}")
    if devices is None:
        count = torch.cuda.device_count()
        dp = count // (tp * fsdp) if dp is None else dp
        n = dp * tp * fsdp
        if dp < 1 or n > count:
            raise ValueError(
                f"a mesh of {n} positions needs {n} CUDA devices and {count} are "
                f"visible; list the devices explicitly (they may repeat: --device "
                f"{','.join(['cuda:0'] * max(n, 1))})"
            )
        devices = [f"cuda:{i}" for i in range(n)]
    devs = tuple(resolve_device(d) for d in parse_devices(devices))
    if dp is None:
        dp = len(devs) // (tp * fsdp)
    if dp * tp * fsdp != len(devs) or dp < 1:
        raise ValueError(f"dp*tp*fsdp = {dp * tp * fsdp} != {len(devs)} devices")
    homes = tuple(devs[d * tp * fsdp] for d in range(dp))
    return Mesh(devices=homes, processes=(0,) * dp, tp=tp, fsdp=fsdp,
                positions=devs if tp * fsdp > 1 else ())


def manual_data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axes the manual-partition step splits the batch over: dp, and
    fsdp when the mesh carries it (the ZeRO-2 data layout)."""
    return ("dp", "fsdp") if "fsdp" in mesh.axis_names else ("dp",)


def data_shard_devices(mesh: Mesh, axes: Sequence[str]) -> List[Tuple[int, int]]:
    """The (d, f) coordinates of the batch shards over `axes`, in the
    order the batch rows split (row-major over (dp, fsdp), as JAX's
    P(("dp", "fsdp")) lays them out)."""
    fs = range(mesh.fsdp) if "fsdp" in axes else (0,)
    return [(d, f) for d in range(mesh.dp) for f in fs]


def slab_partition_map(mesh: Mesh, num_blocks: int, axis: str = "dp") -> Dict[int, Tuple[int, int]]:
    """Shard i on `axis` owns global block rows [start, end): what snapshot
    topology manifests record."""
    n = int(mesh.shape[axis])
    if num_blocks % n != 0:
        raise ValueError(f"num_blocks {num_blocks} not divisible by {axis}={n}")
    bps = num_blocks // n
    return {i: (i * bps, (i + 1) * bps) for i in range(n)}


def shard_slices(batch_size: int, shards: int) -> List[slice]:
    """The rows of each shard in a batch split evenly over `shards` (the
    port's batch_sharding: shard i takes rows [i*B/n, (i+1)*B/n))."""
    if batch_size % shards != 0:
        raise ValueError(f"batch of {batch_size} does not divide over {shards} shards")
    per = batch_size // shards
    return [slice(i * per, (i + 1) * per) for i in range(shards)]
