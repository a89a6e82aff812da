"""Data parallelism on ``torch.distributed``: one process per rank.

Counterpart of ``spiking_diffusion_tpu/parallel/__init__.py``'s 1-D data
mesh (``mesh.py``); ``launch.py`` starts the ranks, which JAX's single
controller does not need. The 2-D (data x model) mesh of the JAX
package's ``parallel/tp.py`` is not ported.
"""

from spiking_diffusion_tpu_torch.parallel.launch import launch
from spiking_diffusion_tpu_torch.parallel.mesh import (
    CollectiveStats,
    Mesh,
    all_gather_rows,
    all_reduce_gradients,
    all_reduce_mean,
    broadcast_object,
    in_process_group,
    make_mesh,
    replicas_equal,
    replicate,
    shard_batch,
    sync_batchnorm,
)

__all__ = ["CollectiveStats", "Mesh", "all_gather_rows", "all_reduce_gradients",
           "all_reduce_mean", "broadcast_object", "in_process_group", "launch", "make_mesh",
           "replicas_equal", "replicate", "shard_batch", "sync_batchnorm"]
