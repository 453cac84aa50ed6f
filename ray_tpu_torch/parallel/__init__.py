"""Parallelism of the port (``ray_tpu/parallel``): the device mesh, the
sharding strategies' rules and their placement on a mesh, the collectives
of a split model, and the multi-process check (``mp_check``)."""

from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, Mesh, MeshConfig,
                                         build_mesh, fake_mesh)
from ray_tpu_torch.parallel.sharding import (ShardingRules, ShardingStrategy,
                                             gather_params, local_params,
                                             shard_params, strategy_from_name)

__all__ = ["AXIS_ORDER", "Mesh", "MeshConfig", "ShardingRules",
           "ShardingStrategy", "build_mesh", "fake_mesh", "gather_params",
           "local_params", "shard_params", "strategy_from_name"]
