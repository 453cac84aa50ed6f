"""The port's podracer run handle (ray_tpu_torch/podracer: PodracerRun,
PodracerConfig, the sliceless plan) against JAX's (ray_tpu/podracer).

The runtime tests of tests/test_podracer.py run on the port's handle, in
process (no runtime) and with runtime=ray_tpu (the members are ray_tpu
actors in a tick_replay compiled DAG, as JAX's are): ticks exactly once
with monotonic versions, the broadcast cadence, and the gang drain with
JAX's own slice plan handed in (zero lost batches, uncharged restarts).
The port's in-process handle, its learner holding JAX's version-1
weights, ticks as JAX's PodracerRun does: the same versions, steps and
rewards, and the learner's metrics within VALUE_TOL.

One module-scoped cluster serves every test: a head of 2 CPUs, a fake TPU
slice of two 1-CPU hosts and two more 1-CPU nodes (the drain test's
shape). The drain test drains a slice host, so it runs last.
"""

import threading
import time
import types

import pytest

from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.podracer import (GangPlacement, PodracerConfig,
                                    PodracerRun, TopologyPlan)
from ray_tpu_torch.podracer import runtime as trt
from ray_tpu_torch.podracer.topology import plan_sliceless
from torch_rllib_parity import close, one_torch_thread  # noqa: F401

TINY = dict(num_actor_gangs=2, actors_per_gang=1, num_envs=1,
            fragment_len=4, hidden=(8, 8), minibatch_size=8, num_epochs=1,
            channel_depth=2, seed=0)


def _tiny_config(**over) -> PodracerConfig:
    return PodracerConfig(**{**TINY, "device": "cpu", **over})


def _jax_config(**over):
    from ray_tpu.podracer import PodracerConfig as JaxConfig
    return JaxConfig(**{**TINY, **over})


def _assert_invariants(run, num_actors: int):
    """tests/test_podracer.py's standing guarantees over every collected
    output: contiguous ticks, each applied exactly once, every gang's batch
    present and aligned, versions monotonic per actor."""
    outs = list(run.outputs)
    first = outs[0]["tick"] if outs else 0
    assert [o["tick"] for o in outs] == \
        list(range(first, first + len(outs)))
    bad = [(o["tick"], o["applied"]) for o in outs
           if o["applied"] != o["tick"] + 1]
    assert not bad, f"learn applied != exactly once: {bad[:5]}"
    assert all(o["tick_skew"] == 0 for o in outs)
    assert all(o["num_batches"] == num_actors for o in outs)
    for i in range(num_actors):
        seq = [o["versions"][i] for o in outs]
        assert all(b >= a for a, b in zip(seq, seq[1:])), \
            f"actor {i} observed a weight-version regression: {seq}"


@pytest.fixture(scope="module")
def cluster():
    """The drain test's cluster (tests/test_podracer.py), with the
    submodules the handle reaches through ray_tpu imported."""
    import ray_tpu
    import ray_tpu._private.object_plane  # noqa: F401
    import ray_tpu.dag.compiled  # noqa: F401
    import ray_tpu.util.scheduling_strategies  # noqa: F401
    from ray_tpu.cluster_utils import Cluster
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    try:
        act_hosts = [c.add_node(num_cpus=1, slice_id="act-slice",
                                resources={"TPU": 4.0, **(
                                    {"TPU-act-head": 1.0} if i == 0 else {})})
                     for i in range(2)]
        for _ in range(2):   # migration headroom off-slice
            c.add_node(num_cpus=1)
        c.connect()
        c.wait_for_nodes()
        yield types.SimpleNamespace(cluster=c, act_hosts=act_hosts,
                                    runtime=ray_tpu)
    finally:
        c.shutdown()


def _runtime(cluster, where):
    return cluster.runtime if where == "ray_tpu" else None


@pytest.mark.timeout(120)
@pytest.mark.parametrize("where", ["local", "ray_tpu"])
def test_ticks_exactly_once_with_monotonic_versions(cluster, where):
    run = PodracerRun(_tiny_config(), runtime=_runtime(cluster, where))
    try:
        run.run(12, window=2, timeout=120)
        _assert_invariants(run, num_actors=2)
        st = run.stats()
        assert st["ticks"] == 12
        assert st["steps"] == 12 * run.config.steps_per_tick()
        # Pipelined up to the channel depth over ray_tpu; in process each
        # tick runs at submission (a DAG of depth 1).
        assert st["max_inflight"] == (2 if where == "ray_tpu" else 1)
        assert st["recoveries"] == 0
        assert st["dag_state"] == ("running" if where == "ray_tpu"
                                   else "local")
    finally:
        run.teardown()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("where", ["local", "ray_tpu"])
def test_broadcast_cadence_and_staleness(cluster, where):
    """broadcast_interval=3: a new version every 3rd update; staleness
    bounded."""
    run = PodracerRun(_tiny_config(broadcast_interval=3, num_actor_gangs=1),
                      runtime=_runtime(cluster, where))
    try:
        outs = run.run(9, window=1, timeout=120)
        assert outs[-1]["version"] == 1 + 3
        assert all(o["staleness"] <= 3 for o in outs)
    finally:
        run.teardown()


@pytest.mark.timeout(120)
def test_oversize_weights_ride_the_object_plane(cluster, monkeypatch):
    """Above the plane's weights threshold the control tuple carries one
    PlaneRef per version, which the actors resolve: the ticks equal the
    in-process run's."""
    rt = cluster.runtime
    monkeypatch.setenv("RAY_TPU_PLANE_THRESHOLD_WEIGHTS", "1")
    run = PodracerRun(_tiny_config(), runtime=rt)
    local = PodracerRun(_tiny_config())
    try:
        assert isinstance(run._ctl_weights, rt._private.object_plane.PlaneRef)
        outs = run.run(4, window=1, timeout=120)
        ref = local.run(4, window=1)
        assert isinstance(run._ctl_weights, rt._private.object_plane.PlaneRef)
        assert len(run._weight_refs) == 5          # one put per version
        for o, r in zip(outs, ref):
            assert (o["versions"], o["steps"], o["rewards"]) == (
                r["versions"], r["steps"], r["rewards"])
            for k, v in o["metrics"].items():
                close(v, r["metrics"][k], what=k)
    finally:
        run.teardown()
        local.teardown()


@pytest.mark.timeout(120)
def test_large_weight_trees_arrive_intact(cluster):
    """A 2.1 MB weight tree (hidden 512x512: above a 1 MiB channel slot,
    below the plane's 4 MiB weights threshold) reaches the caller as a view
    of object-store memory that the store reuses (ROADMAP R-11); the
    handle keeps a copy, and the ticks over ray_tpu equal the in-process
    run's."""
    cfg = dict(hidden=(512, 512))
    run = PodracerRun(_tiny_config(**cfg), runtime=cluster.runtime)
    local = PodracerRun(_tiny_config(**cfg))
    try:
        outs = run.run(4, window=2, timeout=120)
        ref = local.run(4, window=2)
    finally:
        run.teardown()
        local.teardown()
    for o, r in zip(outs, ref):
        assert (o["versions"], o["rewards"]) == (r["versions"], r["rewards"])
        for k, v in o["metrics"].items():
            close(v, r["metrics"][k], what=(o["tick"], k))


@pytest.mark.timeout(120)
def test_first_ticks_match_jax(cluster, jax_cpu, monkeypatch):
    """JAX's PodracerRun on the cluster against the port's in-process
    handle whose learner starts from JAX's version-1 weights: three ticks,
    window 1."""
    from ray_tpu.podracer import PodracerRun as JaxRun
    from ray_tpu.podracer import runtime as jrt
    weights = jrt._Learner(4, 2, lr=5e-4, hidden=TINY["hidden"],
                           seed=0).control()[1]

    class FromJax(trt._Learner):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self._learner.set_weights(params_from_jax(weights))
            self._version = 0
            self._broadcast()

    j = JaxRun(_jax_config(reserve_slices=False))
    try:
        jouts = j.run(3, window=1, timeout=120)
    finally:
        j.teardown()
    monkeypatch.setattr(trt, "_Learner", FromJax)
    run = PodracerRun(_tiny_config())
    try:
        outs = run.run(3, window=1)
    finally:
        run.teardown()
    for o, r in zip(outs, jouts):
        for k in ("tick", "applied", "version", "versions", "staleness",
                  "num_batches", "steps", "rewards"):
            assert o[k] == r[k], (o["tick"], k)
        assert sorted(o["metrics"]) == sorted(r["metrics"])
        for k, v in o["metrics"].items():
            close(v, r["metrics"][k], what=(o["tick"], k))


@pytest.mark.parametrize("mode", ["sebulba", "anakin"])
def test_sliceless_plan(cluster, mode):
    """JAX's planner's branch for a cluster without slices: no
    reservation; Sebulba puts the learner on the head node and each actor
    gang on the next node round-robin, Anakin every gang on the head;
    members carry soft node affinity. In process nothing is placed."""
    rt = cluster.runtime
    cfg = _tiny_config(mode=mode, num_actor_gangs=3)
    plan = plan_sliceless(cfg, rt)
    nodes = [n for n in rt.nodes() if n["Alive"]]
    head = [n["NodeID"] for n in nodes if n["IsHead"]]
    others = [n["NodeID"] for n in nodes if not n["IsHead"]]
    assert plan.mode == mode and plan.learner.node_ids == head
    want = ([head] * 3 if mode == "anakin" else
            [[others[g % len(others)]] for g in range(3)])
    assert [g.node_ids for g in plan.actor_gangs] == want
    for g in [plan.learner] + plan.actor_gangs:
        assert g.slice_id == "" and g.placement_group is None
        (opts,) = g.member_options
        assert opts["scheduling_strategy"].soft is True
    assert plan.describe() == {
        "mode": mode, "learner_slice": "", "actor_slices": ["", "", ""],
        "reserved": 0, "sharding": "dp" if mode == "anakin" else None}
    local = plan_sliceless(cfg)
    assert [g.member_options for g in [local.learner] + local.actor_gangs] \
        == [[{}]] * 4
    plan.teardown()


def test_bad_mode_rejected_and_partial_init_torn_down():
    with pytest.raises(ValueError, match="unknown podracer mode 'vader'"):
        plan_sliceless(PodracerConfig(mode="vader"))
    with pytest.raises(ValueError, match="unknown podracer mode"):
        PodracerRun(_tiny_config(mode="vader"))
    # A plan handed in is released with the run.
    released = []
    plan = TopologyPlan(mode="sebulba", learner=GangPlacement("learner"),
                        actor_gangs=[GangPlacement("actors0")])
    plan.teardown = lambda: released.append(True)
    run = PodracerRun(_tiny_config(num_actor_gangs=1), plan=plan)
    run.teardown()
    run.teardown()
    assert released == [True]


@pytest.mark.timeout(180)
def test_gang_drain_mid_training_zero_lost_batches(cluster, jax_cpu):
    """tests/test_podracer.py's acceptance test on the port's handle, with
    JAX's slice plan handed in: drain one host of the actor slice
    mid-training; zero lost batches, exactly once, uncharged actor
    restarts, recoveries, monotonic versions."""
    from ray_tpu._private import worker_api
    from ray_tpu.podracer import TopologyPlanner

    def actor_info(handle):
        core = worker_api.get_core()
        return worker_api._call_on_core_loop(
            core, core.gcs.request("get_actor_info",
                                   {"actor_id": handle._actor_id}), 10)

    c = cluster.cluster
    plan = TopologyPlanner(_jax_config(mode="sebulba",
                                       reserve_slices=False)).plan()
    assert all(g.slice_id == "act-slice" for g in plan.actor_gangs)
    assert plan.learner.slice_id == ""
    run = PodracerRun(_tiny_config(mode="sebulba", reserve_slices=False),
                      plan, runtime=cluster.runtime)
    errors = []
    stop = threading.Event()
    try:
        run.run(5, window=1, timeout=120)

        def pump():
            while not stop.is_set() and run.ticks < 400:
                try:
                    run.step(timeout=120)
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    return

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        deadline = time.monotonic() + 30
        while run.ticks < 7 and not errors and time.monotonic() < deadline:
            time.sleep(0.05)
        ticks_at_drain = run.ticks
        c.drain_node(cluster.act_hosts[0], deadline_s=8.0, grace_s=0.3,
                     wait=True)
        deadline = time.monotonic() + 60
        while run.ticks <= ticks_at_drain and not errors \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        stop.set()
        t.join(timeout=60)
        assert not t.is_alive()
        assert not errors, errors
        assert run.ticks > ticks_at_drain, "no progress after the drain"
        _assert_invariants(run, num_actors=2)
        assert c.gcs.gang_drains_total >= 1
        assert run.stats()["recoveries"] >= 1
        infos = [actor_info(a) for a in run.actors]
        assert any(i.preempted_restarts >= 1 for i in infos), \
            [(i.num_restarts, i.preempted_restarts) for i in infos]
        for i in infos:
            assert i.num_restarts - i.preempted_restarts == 0, \
                (i.num_restarts, i.preempted_restarts)
        run.run(5, window=1, timeout=120)
        _assert_invariants(run, num_actors=2)
    finally:
        stop.set()
        run.teardown()
