"""Several processes training one model (port of r2d2_tpu/parallel/multihost.py).

Every process runs the same program. Each owns the dp shards of its local
devices (their stores, control planes and collectors); the learner step
sums the shards' gradients within the process and then across processes
with ``torch.distributed``. torchrun's variables take the place of the JAX
package's ``JAX_COORDINATOR_ADDRESS`` and friends: ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``.

The collectives run on the gloo backend: ranks that share a card cannot use
NCCL (it refuses two ranks on one GPU), and the CPU tests have no card.
Gloo takes the CUDA tensors of these all-reduces as they are;
``Collectives.paths`` says which device each collective's tensor was on.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from r2d2_tpu_torch.parallel.mesh import Mesh, parse_devices, slab_partition_map


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def initialize_distributed(backend: str = "gloo", timeout_s: float = 300.0) -> bool:
    """Join the process group torchrun's variables describe; True when a
    multi-process group was formed. With no WORLD_SIZE (or WORLD_SIZE=1)
    this is a no-op and returns False; a group that fails to form raises,
    so a run never goes on training alone."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world <= 1:
        return False
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if not os.environ.get(k)]
    if missing:
        raise ValueError(f"WORLD_SIZE={world} but {', '.join(missing)} unset")
    if not _initialized():
        dist.init_process_group(
            backend,
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            world_size=world,
            rank=int(os.environ["RANK"]),
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    return dist.get_world_size() > 1


def make_global_mesh(devices: Sequence, dp: Optional[int] = None) -> Mesh:
    """The dp mesh over every process's shards: this process's `devices`
    (one per local shard; they may repeat) and as many on every other rank.
    Shard g is owned by rank g // n, n shards a process, so consecutive
    shards stay on one process. dp, when given, must be the global count."""
    from r2d2_tpu_torch.config import resolve_device

    local = [resolve_device(d) for d in parse_devices(devices)]
    n, world = len(local), process_count()
    if world > 1:
        counts = torch.tensor([n, -n], dtype=torch.int64)
        dist.all_reduce(counts, op=dist.ReduceOp.MAX)
        if int(counts[0]) != n or int(-counts[1]) != n:
            raise ValueError("every process must own the same number of shards")
    total = n * world
    if dp is not None and dp != total:
        raise ValueError(f"dp={dp} != {total} shards ({n} a process x {world} processes)")
    return Mesh(devices=tuple(local[g % n] for g in range(total)),
                processes=tuple(g // n for g in range(total)))


def local_axis_indices(mesh: Mesh, axis: str = "dp") -> List[int]:
    """The shard indices along `axis` this process owns."""
    if axis != "dp":
        raise ValueError(f"the port's mesh has only the dp axis, not {axis!r}")
    pid = process_index()
    return [g for g, p in enumerate(mesh.processes) if p == pid]


def local_slab_ranges(mesh: Mesh, num_blocks: int, axis: str = "dp"):
    """The rows of slab_partition_map this process owns: global block ranges
    [start, end) per local shard id."""
    pmap = slab_partition_map(mesh, num_blocks, axis)
    return {g: pmap[g] for g in local_axis_indices(mesh, axis)}


class Collectives:
    """Sums and minima across the processes of a run, in place; the identity
    in one process. Each call is timed on the host clock under its name
    (`seconds`, `calls`), and `paths` records by name the device type of
    the tensor gloo reduced ("cuda" or "cpu"). A failed collective raises.
    Every rank must make the same calls in the same order."""

    def __init__(self):
        self.world = process_count()
        self.paths: Dict[str, str] = {}
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def _reduce(self, t: torch.Tensor, op, what: str) -> torch.Tensor:
        if self.world <= 1:
            return t
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op)
        self.paths[what] = t.device.type
        self.seconds[what] = self.seconds.get(what, 0.0) + time.perf_counter() - t0
        self.calls[what] = self.calls.get(what, 0) + 1
        return t

    def sum_(self, t: torch.Tensor, what: str = "sum") -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.SUM, what)

    def min_(self, t: torch.Tensor, what: str = "min") -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN, what)

    def max_(self, t: torch.Tensor, what: str = "max") -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX, what)

    def sum_int(self, x: int, what: str = "count") -> int:
        """A host integer summed over the processes."""
        if self.world <= 1:
            return int(x)
        return int(self.sum_(torch.tensor([int(x)], dtype=torch.int64), what)[0])

    def any(self, flag: bool, what: str = "flag") -> bool:
        """Whether any process raised `flag`."""
        if self.world <= 1:
            return bool(flag)
        return bool(self.max_(torch.tensor([int(bool(flag))], dtype=torch.int64), what)[0])

    def stats(self) -> Dict[str, object]:
        return {"collective_paths": dict(self.paths),
                **{f"{k}_allreduce_s": v for k, v in self.seconds.items()},
                **{f"{k}_allreduce_calls": v for k, v in self.calls.items()}}
