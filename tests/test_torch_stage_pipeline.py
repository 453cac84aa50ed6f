"""The port's StagePipeline (ray_tpu_torch/parallel/pipeline.py) against
JAX's (ray_tpu/parallel/pipeline.py), and the GPT's MPMD stages.

tests/test_dag.py's two StagePipeline cases run on the port's class: the
proof workload (a pipelined map in order) over ray_tpu actors and in
process, and a stage death absorbed by tick replay over ray_tpu. A 2-layer
fp32 GPT cut into two GPTStages (StackedGPT's layers) gives the logits of
JAX's gpt_forward (gpt_backbone and the head) from the same converted
weights, within 2e-5, in process and as ray_tpu actors; a bf16 activation
crosses a channel bit for bit. One module-scoped ray_tpu cluster.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.parallel import pipeline as P
from ray_tpu_torch.util import local_runtime

CFG = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
           max_seq=64)
LOGITS_TOL = 2e-5


@pytest.fixture(scope="module")
def rt():
    import ray_tpu
    import ray_tpu.dag.compiled  # noqa: F401
    ray_tpu.init(num_cpus=4, num_tpus=0)
    yield ray_tpu
    ray_tpu.shutdown()


def _runtime(rt, where):
    return rt if where == "ray_tpu" else None


def _remote(rt, where, **opts):
    return (rt.remote(**opts) if where == "ray_tpu"
            else local_runtime.remote)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("where", ["local", "ray_tpu"])
def test_stage_pipeline_proof_workload(rt, where):
    """Pipelined map, order preserved (tests/test_dag.py:423)."""
    class Stage:
        def __init__(self, tag):
            self.tag = tag

        def apply(self, x):
            return x + [self.tag]

    cls = _remote(rt, where, num_cpus=1)(Stage)
    stages = [cls.remote(t) for t in ("a", "b", "c")]
    with P.StagePipeline(stages, method="apply", channel_depth=4,
                         runtime=_runtime(rt, where)) as pipe:
        outs = pipe.run([[i] for i in range(10)], timeout=30)
        assert outs == [[i, "a", "b", "c"] for i in range(10)]
        assert pipe.stats()["ticks"] == 10
    if where == "ray_tpu":
        for s in stages:
            rt.kill(s)


def test_stage_pipeline_needs_stages():
    with pytest.raises(ValueError, match="at least one stage"):
        P.StagePipeline([])


@pytest.mark.timeout(120)
def test_stage_pipeline_survives_stage_death(rt):
    """A stage death absorbed by tick replay: run() returns every
    microbatch exactly once (tests/test_dag.py:732)."""
    import os
    import signal
    import threading
    import time as _time

    from ray_tpu._private import worker_api

    @rt.remote(max_restarts=-1)
    class Stage:
        def __init__(self, tag):
            self.tag = tag

        def apply(self, x):
            _time.sleep(0.01)   # keep the stream alive past the kill
            return x + [self.tag]

    stages = [Stage.remote(t) for t in ("a", "b", "c")]
    raylet = worker_api._state.head.raylet
    with P.StagePipeline(stages, method="apply", channel_depth=4,
                         runtime=rt) as pipe:
        victim = next(h.pid for h in raylet.workers.values()
                      if h.actor_id == stages[1]._actor_id)
        timer = threading.Timer(0.4, lambda: os.kill(victim, signal.SIGKILL))
        timer.start()
        try:
            outs = pipe.run([[i] for i in range(150)], timeout=90)
        finally:
            timer.cancel()
        assert outs == [[i, "a", "b", "c"] for i in range(150)]
        assert pipe.stats()["recoveries"] >= 1
    for s in stages:
        rt.kill(s)


@pytest.mark.timeout(60)
def test_oversize_outputs_arrive_intact(rt):
    """Outputs above a channel slot (8 MB against 1 MiB) reach the caller
    as views of object-store memory that the store reuses once the stage
    lets them go (ROADMAP R-11); run() copies each as it arrives, so all
    eight are intact at the end."""
    class Big:
        def apply(self, i):
            import numpy
            return numpy.full(4 << 20, i, dtype=numpy.int16)

    s = rt.remote(num_cpus=1)(Big).remote()
    with P.StagePipeline([s], method="apply", channel_depth=4,
                         runtime=rt) as pipe:
        outs = pipe.run(list(range(8)), timeout=60)
    assert [int(o.min()) for o in outs] == list(range(8))
    assert [int(o.max()) for o in outs] == list(range(8))
    rt.kill(s)


@pytest.fixture(scope="module")
def gpt(jax_cpu):
    """JAX's weights in the stacked layout (flat numpy), the tokens, and
    JAX's fp32 logits."""
    import jax
    from ray_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_tpu.models.gpt import gpt_forward, gpt_init
    from ray_tpu.parallel.pipeline import gpt_params_to_pp
    jcfg = JaxConfig(dtype=jax_cpu.numpy.float32, **CFG)
    tree = jax.tree_util.tree_map(np.asarray,
                                  gpt_init(jax.random.PRNGKey(0), jcfg))
    pp = convert.flatten(jax.tree_util.tree_map(np.asarray,
                                                gpt_params_to_pp(tree)))
    toks = np.random.RandomState(0).randint(0, 256, (3, 2, 32)).astype(
        np.int32)
    logits = [np.asarray(gpt_forward(tree, t, jcfg)[0]) for t in toks]
    return pp, toks, logits


@pytest.mark.timeout(120)
@pytest.mark.parametrize("where", ["local", "ray_tpu"])
def test_gpt_stages_match_jax(rt, gpt, where):
    pp, toks, want = gpt
    cfg = GPTConfig(dtype=torch.float32, **CFG)
    assert sorted(P.stage_params(pp, 2, 0)) == sorted(
        ["embed.table"] + [k for k in pp if k.startswith("stacked.")])
    assert sorted(P.stage_params(pp, 2, 1)) == sorted(
        ["final_norm.scale", "lm_head"]
        + [k for k in pp if k.startswith("stacked.")])
    cls = _remote(rt, where, num_cpus=1)(P.GPTStage)
    stages = [cls.remote(cfg, P.stage_params(pp, 2, i), first=i == 0,
                         last=i == 1, device="cpu") for i in range(2)]
    with P.StagePipeline(stages, method="apply", channel_depth=2,
                         runtime=_runtime(rt, where)) as pipe:
        outs = pipe.run(list(toks), timeout=60)
    for got, ref in zip(outs, want):
        got = P.from_hop(got, "cpu").numpy()
        assert got.shape == ref.shape == (2, 32, 256)
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= LOGITS_TOL, err
    if where == "ray_tpu":
        infos = rt.get([s.where.remote() for s in stages], timeout=60)
        assert len({i["pid"] for i in infos}) == 2
        assert {i["device"] for i in infos} == {"cpu"}
        for s in stages:
            rt.kill(s)


@pytest.mark.timeout(60)
def test_bf16_hop_crosses_a_channel_bit_for_bit(rt):
    """numpy has no bf16: a bf16 activation travels as its int16 bits and
    arrives with every bit."""
    class Double:
        def apply(self, hop):
            # The port is imported in the actor (ray_tpu ships the port's
            # modules by value; a closure over P would carry a copy).
            from ray_tpu_torch.parallel.pipeline import from_hop, to_hop
            return to_hop(from_hop(hop, "cpu") * 2)

    x = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    hop = P.to_hop(x)
    assert hop[0].dtype == np.int16 and hop[1] == "bfloat16"
    assert hop[0].nbytes == x.numel() * 2
    assert torch.equal(P.from_hop(hop, "cpu").view(torch.int16),
                       x.view(torch.int16))
    s = rt.remote(num_cpus=1)(Double).remote()
    with P.StagePipeline([s], method="apply", runtime=rt) as pipe:
        (out,) = pipe.run([hop], timeout=60)
    assert torch.equal(P.from_hop(out, "cpu").view(torch.int16),
                       (x * 2).view(torch.int16))
    hop32 = P.to_hop(x.float())
    assert hop32[1] == "float32"
    assert torch.equal(P.from_hop(hop32, "cpu"), x.float())
    rt.kill(s)


def test_local_dag_runs_a_chain_at_submission():
    """The in-process DAG: each call of the graph once a tick, arguments
    first in order, at submission; an error kept for result(); ray_tpu's
    stats keys; no tick after teardown."""
    calls = []

    class Node:
        def __init__(self, tag):
            self.tag = tag

        def f(self, *xs):
            calls.append(self.tag)
            if xs == ("boom",):
                raise ValueError("boom")
            return [self.tag, *xs]

    a, b, c = (local_runtime.remote(Node).remote(t) for t in "abc")
    with local_runtime.InputNode() as inp:
        shared = a.f.bind(inp)
        root = c.f.bind(shared, b.f.bind(shared), 7)
    dag = local_runtime.dag.compiled.CompiledDAG.compile(
        root, channel_depth=2, tick_replay=True)
    ref = dag.execute_async(1)
    assert calls == ["a", "b", "c"] and dag._next_seq == 1
    assert ref.result(timeout=1) == ["c", ["a", 1], ["b", ["a", 1]], 7]
    bad = dag.execute_async("boom")
    with pytest.raises(ValueError, match="boom"):
        bad.result()
    st = dag.stats()
    assert {k: st[k] for k in ("ticks", "max_inflight", "recoveries",
                               "replayed_ticks", "state")} == {
        "ticks": 1, "max_inflight": 1, "recoveries": 0,
        "replayed_ticks": 0, "state": "local"}
    dag.teardown()
    with pytest.raises(RuntimeError, match="torn down"):
        dag.execute_async(2)
