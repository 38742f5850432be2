"""Data parallelism (counterpart of vcrnet_tpu/parallel/): the mesh and
its collectives, and multi-process bring-up. Point-axis sharding
(``point_sharding``, ``sp_model``, ``sp_flagship``) and the data x point
mesh of ``make_mesh_2d`` are not ported yet."""

from vcrnet_tpu_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
)
from vcrnet_tpu_torch.parallel.multihost import (
    global_batch_from_local,
    initialize,
    local_batch_slice,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "initialize",
    "local_batch_slice",
    "global_batch_from_local",
]
