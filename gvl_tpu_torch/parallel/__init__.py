"""Distribution: process meshes over ``torch.distributed``, tensor-parallel
sharding rules, collectives and stage-parallel perception (counterpart of
:mod:`gvl_tpu.parallel`).  JAX's ``named_sharding`` / ``shard_pytree``
place a whole pytree under GSPMD; here a state dict is sharded per tensor
with :func:`state_specs` and :func:`shard_tensor`."""

from gvl_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    MeshManager,
    build_mesh,
    init_distributed,
    local_device_count,
)
from gvl_tpu_torch.parallel.sharding import (
    ShardingRules,
    shard_tensor,
    spec_for_path,
    state_specs,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "MeshManager",
    "build_mesh",
    "init_distributed",
    "local_device_count",
    "ShardingRules",
    "shard_tensor",
    "state_specs",
    "spec_for_path",
]
