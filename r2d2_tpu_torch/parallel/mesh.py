"""The dp mesh (port of r2d2_tpu/parallel/mesh.py, its dp axis).

A ``Mesh`` names one device per dp shard and the process that owns each
shard. The JAX package reshapes ``jax.devices()`` into a named mesh and
shards arrays over it; here a shard's store, its batch rows and the network
replica that differentiates them simply live on ``mesh.devices[i]``.
Devices may repeat: ``["cuda:0"] * 4`` runs four shards on one card, and
``["cpu"] * 4`` runs them on the CPU (torch has no fake devices, where the
JAX tests get eight from ``XLA_FLAGS``). Repetition changes where a shard
runs, never what it computes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    # the device of each dp shard, as its owning process addresses it
    devices: Tuple[torch.device, ...]
    # the rank of the process that owns each shard (all 0 in one process)
    processes: Tuple[int, ...]

    axis_names = ("dp",)

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp}


def parse_devices(spec: Union[str, torch.device, Sequence]) -> List[torch.device]:
    """Devices from a comma-separated string ("cuda:0,cuda:0"), one device,
    or a sequence of either."""
    if isinstance(spec, torch.device):
        return [spec]
    if isinstance(spec, str):
        spec = [s for s in spec.split(",") if s.strip()]
    return [torch.device(str(d).strip()) if not isinstance(d, torch.device) else d
            for d in spec]


def make_mesh(dp: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A one-process dp mesh. With no devices: cuda:0 .. cuda:dp-1, which
    raises when fewer cards are visible (dp defaults to the visible count).
    Explicit devices may repeat; dp, when given, must equal their count."""
    from r2d2_tpu_torch.config import resolve_device

    if devices is None:
        count = torch.cuda.device_count()
        dp = count if dp is None else dp
        if dp < 1 or dp > count:
            raise ValueError(
                f"dp={dp} needs {dp} CUDA devices and {count} are visible; list the "
                f"devices explicitly (they may repeat: --device "
                f"{','.join(['cuda:0'] * max(dp, 1))})"
            )
        devices = [f"cuda:{i}" for i in range(dp)]
    devs = tuple(resolve_device(d) for d in parse_devices(devices))
    if dp is None:
        dp = len(devs)
    if dp != len(devs) or dp < 1:
        raise ValueError(f"dp = {dp} != {len(devs)} devices")
    return Mesh(devices=devs, processes=(0,) * dp)


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
