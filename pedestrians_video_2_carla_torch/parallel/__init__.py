"""Multi-card training: the ``data`` x ``model`` layout (``mesh.py``) over
one process a device, and the launcher that starts those processes
(``launcher.py``).

The reference's only parallelism was Lightning DDP over NCCL; the JAX
package's is a device mesh with the batch sharded over ``data`` and the
large dense kernels optionally over ``model``. The port runs that layout
as process groups: each rank takes its rows of the global batch, the
losses and BatchNorm's statistics are those of the global batch, the
gradients and metric states are summed over ``data``, and the large
kernels' slices are updated on their own rank and all-gathered whole
before each forward.
"""
from .launcher import launch
from .mesh import (Mesh, MeshConfig, ShardedBatch, make_mesh, replicate,
                   shard_batch, shard_state)

__all__ = ["Mesh", "MeshConfig", "ShardedBatch", "launch", "make_mesh",
           "replicate", "shard_batch", "shard_state"]
