"""Data and tensor parallelism on ``torch.distributed``: one process per rank.

Counterpart of ``spiking_diffusion_tpu/parallel/``: the 1-D data mesh
(``mesh.py``) and the 2-D (data x model) mesh with output-channel-sharded
layers (``tp.py``); ``launch.py`` starts the ranks, which JAX's single
controller does not need.
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
from spiking_diffusion_tpu_torch.parallel.tp import (
    Mesh2D,
    copy_to_model,
    gather_channels,
    gather_features,
    gather_rows,
    make_mesh_2d,
    param_spec,
    replicas_equal_tp,
    shard_batch_2d,
    shard_plan,
    shard_state_tp,
    shard_variables_tp,
    unshard_state_dict,
    unshard_tensors,
)

__all__ = ["CollectiveStats", "Mesh", "Mesh2D", "all_gather_rows", "all_reduce_gradients",
           "all_reduce_mean", "broadcast_object", "copy_to_model", "gather_channels",
           "gather_features", "gather_rows", "in_process_group", "launch", "make_mesh",
           "make_mesh_2d", "param_spec", "replicas_equal", "replicas_equal_tp", "replicate",
           "shard_batch", "shard_batch_2d", "shard_plan", "shard_state_tp",
           "shard_variables_tp", "sync_batchnorm", "unshard_state_dict", "unshard_tensors"]
