"""Data parallelism (port of r2d2_tpu/parallel, its dp half).

The JAX package expresses dp as a named mesh axis and lets XLA insert the
gradient all-reduce. The port keeps the mesh as a list of shard devices
(``mesh.Mesh``): each shard gathers and differentiates its batch_size/dp
rows on its own device, and the learner sums the shards' gradients itself
(``learner.make_sharded_train_step``); across processes the sum rides
``torch.distributed`` (``multihost.Collectives``). Devices may repeat, so
several shards can share one card, or the CPU in the tests.
"""

from r2d2_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
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
    "initialize_distributed",
    "local_axis_indices",
    "local_slab_ranges",
    "make_global_mesh",
    "make_mesh",
    "parse_devices",
    "process_count",
    "process_index",
    "shard_slices",
    "slab_partition_map",
]
