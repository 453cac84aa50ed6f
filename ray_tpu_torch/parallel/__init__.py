"""Parallelism of the port (``ray_tpu/parallel``): the device mesh and the
sharding strategies' rules."""

from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, Mesh, MeshConfig,
                                         build_mesh, fake_mesh)
from ray_tpu_torch.parallel.sharding import (ShardingRules, ShardingStrategy,
                                             strategy_from_name)

__all__ = ["AXIS_ORDER", "Mesh", "MeshConfig", "ShardingRules",
           "ShardingStrategy", "build_mesh", "fake_mesh",
           "strategy_from_name"]
