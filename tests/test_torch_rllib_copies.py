"""The port's own copies of ray_tpu.rllib's numpy modules (sample_batch,
env, connectors, replay_buffer) behave as the originals: the same inputs
and seeds give identical arrays."""

import numpy as np
import pytest

from ray_tpu_torch.rllib import connectors as tconn
from ray_tpu_torch.rllib import env as tenv
from ray_tpu_torch.rllib import replay_buffer as trb
from ray_tpu_torch.rllib import sample_batch as tsb
from torch_rllib_parity import one_torch_thread  # noqa: F401


def _eq(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


ENVS = [("CartPole-v1", {"max_steps": 30}), ("Pendulum-v1", {}),
        ("StatelessCartPole", {}), ("MemoryCue", {"num_cues": 3}),
        ("GridGoal", {"size": 6}),
        ("MultiCartPole", {"num_agents": 2, "max_steps": 20})]


@pytest.mark.parametrize("name,cfg", ENVS, ids=[e[0] for e in ENVS])
def test_env_copies_step_as_the_reference(name, cfg):
    from ray_tpu.rllib import env as jenv
    j, t = jenv.make_env(name, cfg), tenv.make_env(name, cfg)
    _eq(t.reset(seed=3), j.reset(seed=3))
    rng = np.random.RandomState(0)
    multi = name == "MultiCartPole"
    for _ in range(40):
        if multi:
            act = {a: int(rng.randint(2)) for a in j.agents
                   if not j._done[a]}
        elif getattr(j, "continuous", False):
            act = rng.uniform(-2, 2, (1,))
        else:
            act = int(rng.randint(j.num_actions))
        rj, rt = j.step(act), t.step(act)
        _eq(rt, rj)
        done = rj[2]["__all__"] if multi else (rj[2] or rj[3])
        if done:
            _eq(t.reset(), j.reset())
    with pytest.raises(ValueError, match="unknown env"):
        tenv.get_env_creator("nope")
    tenv.register_env("cp", lambda c: tenv.CartPoleEnv(**c))
    assert isinstance(tenv.make_env("cp", {"max_steps": 3}),
                      tenv.CartPoleEnv)


def test_sample_batch_copy_matches_reference():
    from ray_tpu.rllib import sample_batch as jsb
    rng = np.random.default_rng(0)
    cols = {"obs": rng.standard_normal((23, 3)).astype(np.float32),
            "rewards": rng.standard_normal(23),
            "vf_preds": rng.standard_normal(23).astype(np.float32),
            "terminateds": rng.random(23) < 0.2,
            "truncateds": rng.random(23) < 0.1,
            "bootstrap_values": rng.standard_normal(23).astype(np.float32)}
    jb, tb = jsb.SampleBatch(dict(cols)), tsb.SampleBatch(dict(cols))
    for a, b in zip(jb.minibatches(5, 3, seed=2), tb.minibatches(5, 3,
                                                                 seed=2)):
        _eq(b, a)
    assert len(list(tb.minibatches(5, 3, seed=2))) == 12
    _eq(tsb.compute_gae(tb, 0.7, 0.98, 0.9), jsb.compute_gae(jb, 0.7, 0.98,
                                                             0.9))
    _eq(tsb.concat_samples([tb, tb.slice(2, 9)]),
        jsb.concat_samples([jb, jb.slice(2, 9)]))
    _eq(tb.shuffle(4), jb.shuffle(4))
    mj = jsb.MultiAgentBatch.concat_samples(
        [jsb.MultiAgentBatch({"p": jb}, 23)] * 2)
    mt = tsb.MultiAgentBatch.concat_samples(
        [tsb.MultiAgentBatch({"p": tb}, 23)] * 2)
    assert (mt.env_steps(), mt.agent_steps()) == (mj.env_steps(),
                                                  mj.agent_steps())
    _eq(mt.policy_batches["p"], mj.policy_batches["p"])


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffer_copy_matches_reference(prioritized):
    from ray_tpu.rllib import replay_buffer as jrb
    from ray_tpu.rllib import sample_batch as jsb
    kind = "PrioritizedReplayBuffer" if prioritized else "ReplayBuffer"
    j, t = getattr(jrb, kind)(50, seed=1), getattr(trb, kind)(50, seed=1)
    rng = np.random.default_rng(0)
    for i in range(4):
        cols = {"obs": rng.standard_normal((20, 2)), "i": np.full(20, i)}
        j.add(jsb.SampleBatch(cols))
        t.add(tsb.SampleBatch(cols))
        assert len(t) == len(j)
        sj, st = j.sample(16), t.sample(16)
        _eq(st, sj)
        if prioritized:
            prios = rng.random(16) + 0.1
            j.update_priorities(sj["batch_indexes"], prios)
            t.update_priorities(st["batch_indexes"], prios)


def test_connectors_copy_matches_reference():
    from ray_tpu.rllib import connectors as jconn
    rng = np.random.default_rng(0)
    jp = jconn.default_obs_pipeline([jconn.NormalizeObs(),
                                     jconn.ClipObs(-2, 2)])
    tp = tconn.default_obs_pipeline([tconn.NormalizeObs(),
                                     tconn.ClipObs(-2, 2)])
    for _ in range(5):
        x = rng.standard_normal((4, 3)) * 3 + 1
        x[0, 0] = np.nan
        _eq(tp(x), jp(x))
        _eq(tp(x, update=False), jp(x, update=False))
    _eq(tp.state()[1], jp.state()[1])
    ja = jconn.default_action_pipeline(-2.0, 2.0,
                                       [jconn.UnsquashAction(-2.0, 2.0)])
    ta = tconn.default_action_pipeline(-2.0, 2.0,
                                       [tconn.UnsquashAction(-2.0, 2.0)])
    a = rng.standard_normal((4, 1)) * 2
    _eq(ta(a), ja(a))
    _eq(tconn.FlattenObs()(np.ones((2, 3, 4))),
        jconn.FlattenObs()(np.ones((2, 3, 4))))
