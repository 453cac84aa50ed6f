"""Parity: the port's podracer members and serve's ``_jsonable`` against
ray_tpu's, and the port's members as ray_tpu actors.

The members (``ray_tpu_torch/podracer/runtime.py``) run in process on the
CPU against JAX's ``_RolloutWorker`` and ``_Learner`` from the same numpy
weights and seeds: the sampled columns are identical where they are
numpy's draws (actions, observations, rewards) and within VALUE_TOL where
they are network outputs (tests/torch_rllib_parity.py); the learner's
metrics and weights after ``learn`` likewise, with Adam's bounds.

The worker check: ``ray_tpu``'s workers mirror ``JAX_PLATFORMS`` into
JAX's config at start (``_private/worker_main.py``); a worker that then
imports torch and runs the port's members must give what the members give
in process. The members are wired into ``ray_tpu``'s ``CompiledDAG`` as
``PodracerRun._build`` wires JAX's.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.convert import flatten, params_from_jax
from ray_tpu_torch.podracer import runtime as trt
from ray_tpu_torch.serve.proxy import _jsonable
from torch_rllib_parity import (assert_adam_update_close, close,
                                one_torch_thread)  # noqa: F401

ENV, ENV_CFG = "CartPole-v1", {"max_steps": 15}
HIDDEN = (8, 8)
FRAG, ENVS = 12, 2
LR = 5e-4
FLOAT_COLS = ("action_logp", "advantages", "value_targets")


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _worker(cls, seed, **kw):
    return cls(ENV, ENV_CFG, ENVS, FRAG, seed, hidden=HIDDEN, **kw)


def _learner(cls, **kw):
    return cls(4, 2, lr=LR, hidden=HIDDEN, minibatch_size=8, num_epochs=2,
               seed=0, **kw)


def _collects_equal(a, b):
    """Two collect outputs: the same dict, columns as the module says."""
    assert sorted(a) == sorted(b)
    for k in a:
        if k != "columns":
            assert a[k] == b[k], k
    assert sorted(a["columns"]) == sorted(b["columns"])
    for k, v in a["columns"].items():
        if k in FLOAT_COLS:
            close(v, b["columns"][k], what=k)
        else:
            np.testing.assert_array_equal(v, b["columns"][k], err_msg=k)


def _learned_equal(a, b):
    """Two learn outputs: the same stamps and counts, metrics within
    VALUE_TOL, the weight trees of the same layout."""
    assert sorted(a) == sorted(b)
    for k in a:
        if k not in ("metrics", "weights"):
            assert a[k] == b[k], k
    assert sorted(a["metrics"]) == sorted(b["metrics"])
    for k, v in a["metrics"].items():
        close(v, b["metrics"][k], what=k)
    fa, fb = flatten(a["weights"]), flatten(b["weights"])
    assert {k: (v.shape, v.dtype) for k, v in fa.items()} == {
        k: (v.shape, v.dtype) for k, v in fb.items()}


def test_rollout_worker_collect_matches_jax(jx):
    """Two ticks: the first announces the learner's version-1 weights, the
    second sends none (the worker keeps them)."""
    from ray_tpu.podracer import runtime as jrt
    version, weights = _learner(jrt._Learner).control()
    j = _worker(jrt._RolloutWorker, 1000)
    t = _worker(trt._RolloutWorker, 1000, device="cpu")
    for tick, w in ((0, weights), (1, None)):
        ctl = (tick, version, w)
        _collects_equal(t.collect(ctl), j.collect(ctl))
    assert t.versions_seen() == j.versions_seen() == [1, 1]


def test_learner_learn_matches_jax(jx):
    """Two ticks of two members' batches, the port's learner holding the
    JAX learner's weights: outputs, weights after, and the numpy tree of
    JAX's ``_to_numpy_tree``."""
    from ray_tpu.podracer import runtime as jrt
    j = _learner(jrt._Learner)
    t = _learner(trt._Learner, device="cpu")
    t._learner.set_weights(params_from_jax(j.control()[1]))
    t._broadcast()
    j._version = t._version = 1
    _version, weights = j.control()
    workers = [_worker(jrt._RolloutWorker, 1000 * (i + 1)) for i in range(2)]
    steps = 0
    for tick in range(2):
        batches = [w.collect((tick, 1, weights if tick == 0 else None))
                   for w in workers]
        out_j, out_t = j.learn(*batches), t.learn(*batches)
        _learned_equal(out_t, out_j)
        assert out_t["applied"] == tick + 1 and out_t["version"] == tick + 2
        steps += int(out_t["metrics"]["num_minibatch_updates"])
    assert_adam_update_close(t._learner, j._learner.params,
                             j._learner.opt_state, LR, steps)
    ref = flatten(jrt._to_numpy_tree(j._learner.params))
    tree = flatten(t.control()[1])
    assert sorted(tree) == sorted(ref)
    for k, v in tree.items():
        assert isinstance(v, np.ndarray) and v.dtype == ref[k].dtype, k
        close(v, ref[k], tol=2 * LR * steps, what=k)


def test_to_numpy_tree_is_a_copy_of_the_state():
    from ray_tpu_torch.rllib.learner import PPOLearner
    module = PPOLearner(4, 2, hidden=HIDDEN, device="cpu").module
    tree = trt._to_numpy_tree(module.state_dict())
    assert sorted(tree) == ["pi", "vf"] and len(tree["pi"]) == 3
    for k, v in flatten(tree).items():
        np.testing.assert_array_equal(v, module.state_dict()[k].numpy())
    # A copy: the learner's next step does not move the broadcast tree.
    before = flatten(tree)["pi.0.w"].copy()
    with torch.no_grad():
        module.pi[0].w.add_(1.0)
    np.testing.assert_array_equal(flatten(tree)["pi.0.w"], before)


def test_jsonable_matches_jax(jx):
    from ray_tpu.serve.proxy import _jsonable as jax_jsonable
    value = {"a": [np.float32(1.5), np.int64(3), (np.arange(4) * 0.5)],
             "b": {"c": np.ones((2, 2), np.float32), "d": "text",
                   "e": None, "f": True},
             "g": (1, 2.5, [np.bool_(True)])}
    assert _jsonable(value) == jax_jsonable(value)
    # torch tensors where JAX knows jax.Array: host lists of the values.
    jax_value = {"t": jx.numpy.arange(6, dtype=jx.numpy.float32)
                 .reshape(2, 3), "s": jx.numpy.float32(2.0)}
    torch_value = {"t": torch.arange(6, dtype=torch.float32).reshape(2, 3)
                   .requires_grad_(), "s": torch.tensor(2.0)}
    assert _jsonable(torch_value) == jax_jsonable(jax_value)
    assert _jsonable([torch.tensor([0.5], dtype=torch.bfloat16)]) == [[0.5]]


@pytest.mark.timeout(240)
def test_members_run_as_ray_tpu_actors(ray_start):
    """The worker check: the port's members as actors on the CPU, bound
    into a CompiledDAG as PodracerRun._build binds them, tick for tick
    equal to the same members in process; the workers hold JAX's platform
    as the environment says and import torch beside it."""
    import ray_tpu
    from ray_tpu.dag import InputNode
    from ray_tpu.dag.compiled import CompiledDAG

    @ray_tpu.remote
    def probe():
        import os
        import sys
        import jax
        import ray_tpu_torch.rllib.learner  # noqa: F401
        return (os.environ.get("JAX_PLATFORMS"),
                jax.config.jax_platforms, "torch" in sys.modules)

    assert ray_tpu.get(probe.remote(), timeout=120) == ("cpu", "cpu", True)
    actor_cls = ray_tpu.remote(num_cpus=1)(trt._RolloutWorker)
    learner_cls = ray_tpu.remote(num_cpus=1)(trt._Learner)
    seeds = (1000, 2000)
    actors = [actor_cls.remote(ENV, ENV_CFG, ENVS, FRAG, s, hidden=HIDDEN,
                               device="cpu") for s in seeds]
    learner = learner_cls.remote(4, 2, lr=LR, hidden=HIDDEN,
                                 minibatch_size=8, num_epochs=2, seed=0,
                                 device="cpu")
    version, weights = ray_tpu.get(learner.control.remote(), timeout=120)
    ray_tpu.get([a.ping.remote() for a in actors], timeout=120)
    with InputNode() as inp:
        root = learner.learn.bind(*[a.collect.bind(inp) for a in actors])
    dag = CompiledDAG.compile(root, channel_depth=2, max_message_size=1 << 20,
                              tick_replay=True, patient_readers=True)
    local_actors = [_worker(trt._RolloutWorker, s, device="cpu")
                    for s in seeds]
    local = _learner(trt._Learner, device="cpu")
    try:
        for tick in range(3):
            out = dag.execute_async((tick, version, weights)).result(60)
            ctl = (tick, version, weights)
            ref = local.learn(*[a.collect(ctl) for a in local_actors])
            _learned_equal(out, ref)
            for k, v in flatten(out["weights"]).items():
                np.testing.assert_array_equal(
                    v, flatten(ref["weights"])[k], err_msg=k)
            version, weights = out["version"], out["weights"]
        assert version == 4
    finally:
        dag.teardown()
        for a in actors + [learner]:
            ray_tpu.kill(a)
