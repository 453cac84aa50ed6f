"""Podracer topology: the port's copies of ``PodracerConfig``,
``GangPlacement`` and ``TopologyPlan`` (``ray_tpu/podracer/topology.py``
:32, :71, :84), and the plan of a cluster without slices.

JAX's ``TopologyPlanner`` (:132) reads the TPU slice inventory
(``NodeInfo.slice_id``), reserves each gang's slice with a
``slice_placement_group`` and hands the Anakin learner a sharding
strategy over the slice's mesh. None of that exists for a card, so the
planner stays TPU-side. ``plan_sliceless`` is its branch for a cluster
without slices (``plan()`` :200 with no slice ids, ``_member_options``
:173): no reservations, the learner on the head node, each actor gang
on the next node round-robin with a soft ``NodeAffinitySchedulingStrategy``
(Anakin puts every gang on the head node). A slice cluster's user
hands ``PodracerRun`` JAX's own plan instead (``TopologyPlanner(cfg)
.plan()``); the run reads only its ``mode``, each gang's
``member_options`` and ``teardown()``.

The runtime is handed in (``runtime=ray_tpu``): nodes come from
``runtime.nodes()``, the affinity strategy from
``runtime.util.scheduling_strategies`` and the reservations' release from
``runtime.util.remove_placement_group``. With no runtime the plan places
nothing: every member lives in the caller's process.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.parallel.sharding import strategy_from_name
from ray_tpu_torch.train.worker_group import required_attr, runtime_attr


@dataclass
class PodracerConfig:
    """One knob set for planner + runtime (kept flat on purpose: the
    whole config crosses to actor constructors as plain values)."""

    mode: str = "sebulba"              # "sebulba" | "anakin"
    env: Any = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_actor_gangs: int = 2
    actors_per_gang: int = 1
    num_envs: int = 1                  # env copies per actor
    fragment_len: int = 16             # steps per env per tick
    hidden: tuple = (32, 32)
    lr: float = 5e-4
    gamma: float = 0.99
    lam: float = 0.95
    minibatch_size: int = 64
    num_epochs: int = 1
    seed: int = 0
    # Weight broadcast cadence: a new version is put to the object plane
    # every `broadcast_interval` learner updates (1 = every tick).
    broadcast_interval: int = 1
    # Compiled-DAG channel tuning: depth bounds pipelined ticks in
    # flight (= how stale actor weights may run under execute_async).
    channel_depth: int = 2
    max_message_size: int = 1 << 20
    # Anakin learner placement strategy (parallel/sharding preset name).
    learner_sharding: str = "dp"
    # Gang-reserve each gang's slice with a slice_placement_group.
    # None = auto (reserve when the slice exposes TPU resources).
    reserve_slices: Optional[bool] = None
    actor_num_cpus: float = 1.0
    learner_num_cpus: float = 1.0
    # The learner's device: None -> the card, "cpu" on request. The
    # rollout actors run their policy on the CPU.
    device: Optional[str] = None

    def steps_per_tick(self) -> int:
        return (self.num_actor_gangs * self.actors_per_gang
                * self.num_envs * self.fragment_len)


@dataclass
class GangPlacement:
    """Where one gang (learner or actor gang) lives."""

    role: str                          # "learner" | "actors[i]"
    slice_id: str = ""                 # "" = off-slice
    node_ids: List[str] = field(default_factory=list)
    # Per-member .options() kwargs (scheduling_strategy etc.), one per
    # gang member, round-robin over the domain's hosts.
    member_options: List[Dict[str, Any]] = field(default_factory=list)
    placement_group: Any = None        # slice reservation (or None)


@dataclass
class TopologyPlan:
    mode: str
    learner: GangPlacement = None
    actor_gangs: List[GangPlacement] = field(default_factory=list)
    sharding: Any = None               # ShardingStrategy (Anakin learner)
    slices: Dict[str, List[str]] = field(default_factory=dict)
    # The runtime whose placement groups the plan holds (None: in process).
    runtime: Any = None

    def describe(self) -> dict:
        return {
            "mode": self.mode,
            "learner_slice": self.learner.slice_id if self.learner else "",
            "actor_slices": [g.slice_id for g in self.actor_gangs],
            "reserved": sum(1 for g in ([self.learner] + self.actor_gangs)
                            if g and g.placement_group is not None),
            "sharding": getattr(self.sharding, "name", None),
        }

    def teardown(self):
        """Release every slice reservation the plan holds."""
        remove = runtime_attr(self.runtime, "util.remove_placement_group")
        for g in [self.learner] + list(self.actor_gangs):
            if g is not None and g.placement_group is not None:
                try:
                    remove(g.placement_group)
                except Exception:  # noqa: BLE001 — cluster already down
                    pass
                g.placement_group = None


def _member_options(nodes: List[dict], count: int, affinity) -> List[dict]:
    """Soft NodeAffinity round-robin over the domain's hosts: the
    scheduler lands members there, and a drain can still migrate them off
    (hard affinity would pin a migrating actor to its dead node)."""
    if not nodes:
        return [{} for _ in range(count)]
    return [{"scheduling_strategy": affinity(nodes[i % len(nodes)]["NodeID"],
                                             soft=True)}
            for i in range(count)]


def plan_sliceless(config: PodracerConfig, runtime=None) -> TopologyPlan:
    """The plan of JAX's ``TopologyPlanner.plan()`` on a cluster without
    slices (module doc): every gang off-slice, no reservation."""
    if config.mode not in ("sebulba", "anakin"):
        raise ValueError(f"unknown podracer mode {config.mode!r} "
                         f"(one of 'sebulba', 'anakin')")
    alive = [] if runtime is None else [
        n for n in runtime.nodes() if n["Alive"] and not n.get("Draining")]
    affinity = required_attr(
        runtime, "util.scheduling_strategies.NodeAffinitySchedulingStrategy",
        "ray_tpu.util.scheduling_strategies") if alive else None

    def gang(role, members, count):
        return GangPlacement(role=role,
                             node_ids=[n["NodeID"] for n in members],
                             member_options=_member_options(members, count,
                                                            affinity))

    plan = TopologyPlan(mode=config.mode, runtime=runtime)
    home = [n for n in alive if n.get("IsHead")] or alive[:1]
    plan.learner = gang("learner", home, 1)
    if config.mode == "anakin":
        plan.sharding = strategy_from_name(config.learner_sharding)
        others = home
    else:
        others = [n for n in alive if n not in home] or home
    for g in range(config.num_actor_gangs):
        members = others if config.mode == "anakin" else (
            [others[g % len(others)]] if others else [])
        plan.actor_gangs.append(gang(f"actors{g}", members,
                                     config.actors_per_gang))
    return plan
