"""Podracer RL substrate in the port: ``ray_tpu/podracer``'s run handle
``PodracerRun``, its config and plan types, and the members it drives
(``runtime.py``), with the learner on the card.

JAX's ``TopologyPlanner`` is left out: it plans over TPU slice fault
domains (slice inventory, slice placement groups, an Anakin sharding over
the slice's mesh), which a card cluster does not have. The port plans a
cluster without slices (``topology.plan_sliceless``, the planner's
sliceless branch), and a slice cluster's user hands ``PodracerRun`` JAX's
plan.
"""

from ray_tpu_torch.podracer.topology import (GangPlacement, PodracerConfig,
                                             TopologyPlan)
from ray_tpu_torch.podracer.runtime import PodracerRun

__all__ = ["PodracerConfig", "TopologyPlan", "GangPlacement", "PodracerRun"]
