"""Parallelism (port of r2d2_tpu/parallel: the dp, tp and fsdp axes).

The JAX package expresses its axes as a named mesh and lets XLA insert the
collectives. The port keeps the mesh as the device of every (dp, tp, fsdp)
position (``mesh.Mesh``): each dp shard gathers and differentiates its
rows on its own device, and the learner sums the shards' gradients itself
(``learner.make_sharded_train_step``); across processes the sum rides
``torch.distributed`` (``multihost.Collectives``). ``sharding_map.py``
places each parameter and Adam moment over tp and fsdp from the JAX
package's table. Devices may repeat, so several positions can share one
card, or the CPU in the tests.
"""

from r2d2_tpu_torch.parallel.mesh import (
    Mesh,
    data_shard_devices,
    make_mesh,
    manual_data_axes,
    parse_devices,
    shard_slices,
    slab_partition_map,
)
from r2d2_tpu_torch.parallel.multihost import (
    Collectives,
    initialize_distributed,
    local_axis_indices,
    local_slab_ranges,
    make_global_mesh,
    process_count,
    process_index,
)

__all__ = [
    "Collectives",
    "Mesh",
    "data_shard_devices",
    "initialize_distributed",
    "local_axis_indices",
    "local_slab_ranges",
    "make_global_mesh",
    "make_mesh",
    "manual_data_axes",
    "parse_devices",
    "process_count",
    "process_index",
    "shard_slices",
    "slab_partition_map",
]
