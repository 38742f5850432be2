"""Data and point-axis parallelism (counterpart of vcrnet_tpu/parallel/):
the mesh and its collectives (``mesh``, with the data x point grid of
``make_mesh_2d``), multi-process bring-up (``multihost``), and the
point-sharded primitives and model forwards with their gradients
(``point_sharding``, ``sp_model``, ``sp_flagship``), imported from their
modules as in the JAX package."""

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
