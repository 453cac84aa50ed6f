"""Parity: the port's env runners, and the slice as a whole, against
ray_tpu.rllib's.

A JAX runner and a port runner on the CPU are built with the same seed and
the port's runner takes the JAX runner's weights (``rllib/convert.py``).
Both step the same envs from the same seeds and draw actions from the
same ``np.random.RandomState`` over probabilities that agree to fp32, so
the actions, rewards, observations and episode ends are identical; the
network outputs (logp, vf_preds, bootstrap values, advantages, value
targets, carries) are held to VALUE_TOL (tests/torch_rllib_parity.py).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import convert
from ray_tpu_torch.rllib import env_runner as ter
from ray_tpu_torch.rllib import learner as tlearner
from ray_tpu_torch.rllib import replay_buffer as trb
from ray_tpu_torch.rllib import sample_batch as tsb
from ray_tpu_torch.rllib.algorithms import c51 as tc51
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import noisy as tnoisy
from ray_tpu_torch.rllib.algorithms import qrdqn as tqr
from ray_tpu_torch.rllib.algorithms import r2d2 as tr2d2
from ray_tpu_torch.rllib.models import seeded
from torch_rllib_parity import (assert_adam_update_close, batches_equal,
                                close, np_tree,
                                one_torch_thread)  # noqa: F401

FLOAT_KEYS = ("action_logp", "vf_preds", "bootstrap_values", "advantages",
              "value_targets", "state_in_h", "state_in_c")


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _pair(jcls, tcls, *args, **kw):
    """A JAX runner and a port runner on the CPU holding its weights."""
    j = jcls(*args, **kw)
    t = tcls(*args, device="cpu", **kw)
    t.set_weights(convert.params_from_jax(np_tree(j._params)))
    return j, t


SAMPLE_CASES = {
    # name: (env, env_config, model)
    "mlp": ("CartPole-v1", {"max_steps": 15}, None),
    "cnn": ("GridGoal", {"size": 5, "max_steps": 6}, {"fcnet_hiddens": [8]}),
    "lstm": ("StatelessCartPole", {"max_steps": 12},
             {"fcnet_hiddens": [8], "use_lstm": True,
              "lstm_cell_size": 8}),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_matches_jax(jx, case):
    """Two fragments (the second continues the first's envs and carries),
    with truncations that bootstrap from V and terminations."""
    from ray_tpu.rllib.env_runner import EnvRunner
    env, cfg, model = SAMPLE_CASES[case]
    j, t = _pair(EnvRunner, ter.EnvRunner, env, cfg, 2, 5, hidden=(16,),
                 model=model)
    for _ in range(2):
        bj, bt = j.sample(24, gamma=0.97, lam=0.9), t.sample(24, 0.97, 0.9)
        batches_equal(bt, bj, FLOAT_KEYS)
        assert bj["terminateds"].any() or bj["truncateds"].any()
    assert t.episode_rewards() == j.episode_rewards()


@pytest.mark.parametrize("runner", ["plain", "dueling", "catalog", "c51",
                                    "qrdqn"])
def test_sample_transitions_matches_jax(jx, runner):
    from ray_tpu.rllib import env_runner as jer
    from ray_tpu.rllib.algorithms import c51 as jc51
    from ray_tpu.rllib.algorithms import dqn as jdqn
    from ray_tpu.rllib.algorithms import qrdqn as jqr
    env, cfg, kw = "CartPole-v1", {"max_steps": 20}, {}
    classes = {"plain": (jer.EnvRunner, ter.EnvRunner),
               "dueling": (jdqn.DuelingDQNRunner, tdqn.DuelingDQNRunner),
               "catalog": (jdqn.CatalogQRunner, tdqn.CatalogQRunner),
               "c51": (jc51.C51Runner, tc51.C51Runner),
               "qrdqn": (jqr.QRDQNRunner, tqr.QRDQNRunner)}
    if runner == "catalog":
        env, cfg = "GridGoal", {"size": 5, "max_steps": 8}
        kw = {"model": {"fcnet_hiddens": [8]}}
    elif runner == "c51":
        kw = {"n_atoms": 11, "v_min": -5.0, "v_max": 5.0}
    elif runner == "qrdqn":
        kw = {"n_quantiles": 8}
    j, t = _pair(*classes[runner], env, cfg, 3, 1, hidden=(16,), **kw)
    for eps in (0.0, 0.3):
        batches_equal(t.sample_transitions(20, eps),
                      j.sample_transitions(20, eps))


def test_noisy_runner(jx):
    """With sigma 0 the noise does nothing and the port's noisy runner acts
    as JAX's does; with noise, its greedy actions are those of
    noisy_net_apply under draws from a generator seeded seed + 77."""
    from ray_tpu.rllib.algorithms.noisy import NoisyDQNRunner
    j, t = _pair(NoisyDQNRunner, tnoisy.NoisyDQNRunner, "CartPole-v1", {},
                 2, 3, hidden=(16,), sigma0=0.0)
    batches_equal(t.sample_transitions(16), j.sample_transitions(16))
    t = tnoisy.NoisyDQNRunner("CartPole-v1", {}, 2, 3, hidden=(16,),
                              device="cpu")
    q_net = t.module["q"]
    gen = seeded(3 + 77)
    obs0 = np.stack(t._obs).astype(np.float32)
    with torch.no_grad():
        q = tnoisy.noisy_net_apply(q_net, torch.from_numpy(obs0),
                                   tnoisy.noisy_net_noise(q_net, gen))
    b = t.sample_transitions(1)
    np.testing.assert_array_equal(b["actions"], q.argmax(-1).numpy())


def test_r2d2_runner_matches_jax(jx):
    from ray_tpu.rllib.algorithms.r2d2 import R2D2Runner
    j, t = _pair(R2D2Runner, tr2d2.R2D2Runner, "MemoryCue", {"delay": 2}, 3,
                 2, hidden=(8,), lstm_cell_size=8)
    for eps in (0.0, 0.4):
        batches_equal(t.sample_sequences(7, eps), j.sample_sequences(7, eps),
                      FLOAT_KEYS)
    w = convert.params_from_jax(np_tree(j._params))
    assert t.evaluate_return(w, episodes=3) == j.evaluate_return(
        j._params, episodes=3)


@pytest.mark.parametrize("model", [None, {"fcnet_hiddens": [8],
                                          "use_lstm": True,
                                          "lstm_cell_size": 4}],
                         ids=["mlp", "lstm"])
def test_flat_params_and_perturbations_match_jax(jx, model):
    """get_flat_params is JAX's ravel_pytree vector; ES/ARS perturbations
    of it (noise rebuilt from each seed) score the same greedy returns."""
    from ray_tpu.rllib.env_runner import EnvRunner
    env = "StatelessCartPole" if model else "CartPole-v1"
    j, t = _pair(EnvRunner, ter.EnvRunner, env, {"max_steps": 40}, 1, 0,
                 hidden=(8,), model=model)
    flat = j.get_flat_params()
    np.testing.assert_array_equal(t.get_flat_params(), flat)
    seeds = [11, 12, 13]
    assert (t.evaluate_perturbations(flat, seeds, 0.5, max_steps=40)
            == j.evaluate_perturbations(flat, seeds, 0.5, max_steps=40))


def test_multi_agent_sample_matches_jax(jx):
    from ray_tpu.rllib.env_runner import MultiAgentEnvRunner
    args = ("MultiCartPole", {"num_agents": 2, "max_steps": 12},
            ["p0", "p1"], lambda a: "p" + a[-1])
    j = MultiAgentEnvRunner(*args, num_envs=2, seed=4, hidden=(16,))
    t = ter.MultiAgentEnvRunner(*args, num_envs=2, seed=4, hidden=(16,),
                                device="cpu")
    t.set_weights({pid: convert.params_from_jax(np_tree(p))
                   for pid, p in j._params.items()})
    for _ in range(2):
        mj, mt = j.sample(20), t.sample(20)
        assert mt.env_steps() == mj.env_steps()
        assert mt.agent_steps() == mj.agent_steps()
        assert sorted(mt.policy_batches) == sorted(mj.policy_batches)
        for pid in mj.policy_batches:
            batches_equal(mt.policy_batches[pid], mj.policy_batches[pid],
                          FLOAT_KEYS)
    assert t.episode_rewards() == j.episode_rewards()


def test_ppo_slice_matches_jax(jx):
    """The slice as a whole: two PPO iterations on CartPole, each
    runner.sample -> concat_samples -> learner.update ->
    runner.set_weights, in JAX and in the port from one converted init.
    The batches match (identical actions) and so do the final weights."""
    from ray_tpu.rllib import sample_batch as jsb
    from ray_tpu.rllib.env_runner import EnvRunner
    from ray_tpu.rllib.learner import PPOLearner
    jl = PPOLearner(4, 2, hidden=(16, 16), lr=5e-4, seed=0)
    tl = tlearner.PPOLearner(4, 2, hidden=(16, 16), lr=5e-4, seed=0,
                             device="cpu")
    convert.load_learner(tl, np_tree(jl.params))
    jr = EnvRunner("CartPole-v1", {}, 2, 0, hidden=(16, 16))
    tr = ter.EnvRunner("CartPole-v1", {}, 2, 0, hidden=(16, 16),
                       device="cpu")
    jr.set_weights(jl.get_weights())
    tr.set_weights(tl.get_weights())
    steps = 0
    for it in range(2):
        bj = jsb.concat_samples([jr.sample(64)])
        bt = tsb.concat_samples([tr.sample(64)])
        batches_equal(bt, bj, FLOAT_KEYS)
        mj = jl.update(bj, minibatch_size=32, num_epochs=2, seed=it)
        mt = tl.update(bt, minibatch_size=32, num_epochs=2, seed=it)
        for k in mj:
            close(mt[k], mj[k], what=k)
        steps += mt["num_minibatch_updates"]
        jr.set_weights(jl.get_weights())
        tr.set_weights(tl.get_weights())
    assert_adam_update_close(tl, jl.params, jl.opt_state, 5e-4, steps)
    batches_equal(tsb.concat_samples([tr.sample(16)]),
                  jsb.concat_samples([jr.sample(16)]), FLOAT_KEYS)


def test_dqn_iteration_matches_jax(jx):
    """One DQN iteration as DQN.training_step runs it: sample transitions,
    n-step them, add to replay, two replayed updates, a target sync, the
    weights back to the runner; then the next sample."""
    from ray_tpu.rllib import replay_buffer as jrb
    from ray_tpu.rllib.algorithms import dqn as jdqn
    from ray_tpu.rllib.env_runner import EnvRunner
    jl = jdqn.DQNLearner(4, 2, hidden=(16,), lr=5e-4, seed=0)
    tl = tdqn.DQNLearner(4, 2, hidden=(16,), lr=5e-4, seed=0, device="cpu")
    convert.load_learner(tl, np_tree(jl.params))
    jr = EnvRunner("CartPole-v1", {}, 2, 0, hidden=(16,))
    tr = ter.EnvRunner("CartPole-v1", {}, 2, 0, hidden=(16,), device="cpu")
    jr.set_weights(jl.get_weights())
    tr.set_weights(tl.get_weights())
    jbuf = jrb.PrioritizedReplayBuffer(1000, seed=0)
    tbuf = trb.PrioritizedReplayBuffer(1000, seed=0)
    for buf, runner, mod in ((jbuf, jr, jdqn), (tbuf, tr, tdqn)):
        buf.add(mod.nstep_transform(runner.sample_transitions(32, 0.5), 3,
                                    0.99, 2))
    for _ in range(2):
        rj, rt = jbuf.sample(32), tbuf.sample(32)
        batches_equal(rt, rj)
        mj, mt = jl.update(rj), tl.update(rt)
        close(mt["loss"], mj["loss"])
        close(mt["td_error"], mj["td_error"])
        jbuf.update_priorities(rj["batch_indexes"], mj["td_error"] + 1e-6)
        tbuf.update_priorities(rt["batch_indexes"], mt["td_error"] + 1e-6)
    assert_adam_update_close(tl, jl.params, jl.opt_state, 5e-4, 2)
    jl.sync_target()
    tl.sync_target()
    jr.set_weights(jl.get_weights())
    tr.set_weights(tl.get_weights())
    batches_equal(tr.sample_transitions(16, 0.1),
                  jr.sample_transitions(16, 0.1))
