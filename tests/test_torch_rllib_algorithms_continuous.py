"""Parity: the port's continuous-control and offline algorithms (SAC,
TD3, DDPG, CQL, BC, MARWIL), built from their configs, against
ray_tpu.rllib's on a ray_tpu cluster; and every algorithm's checkpoint
round trip.

SAC, TD3, DDPG and CQL draw inside their updates. JAX draws from its key
inside ``jit``, the port from a device generator: each case records the
draws of each JAX update, rebuilt from the JAX learner's key as the JAX
code splits it, and hands them to the port's update (``noise=``). The
runners act uniformly at random from numpy for the whole run (the
warm-up), so the transitions, the replay buffer and its sampled rows are
the same on both sides: the buffers are held equal, the losses within
VALUE_TOL, the learners' state and Adam moments with the bounds of
``tests/torch_rllib_parity.py``, and TD3's delayed-actor counter exactly.
The squashed-Gaussian actor's last layer is scaled by 0.1 in both (R-5, as
in ``test_torch_rllib_continuous``).
"""

import numpy as np
import pytest

import ray_tpu_torch.rllib as R
from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_samples
from test_torch_rllib_continuous import _state_matches
from torch_rllib_algo_parity import (cluster, pair, results_match,  # noqa
                                     small, train_both)
from torch_rllib_parity import (assert_adam_update_close, close,
                                one_torch_thread)  # noqa: F401

LOW, HIGH = -2.0, 2.0
GRAD_STEPS = 4


def _sac_draws(key, n, act, cql_ood=0):
    """One SAC (or CQL) update's draws from the learner's key (as
    ``test_torch_rllib_continuous._sac_noise``, at batch ``n``)."""
    import jax
    _key, sub = jax.random.split(key)
    rng_c, rng_a = jax.random.split(sub)
    noise = {"actor": jax.random.normal(rng_a, (n, act))}
    if cql_ood:
        r_td, r_ood, r_pi, _ = jax.random.split(rng_c, 4)
        noise.update(
            critic=jax.random.normal(r_td, (n, act)),
            ood=jax.random.uniform(r_ood, (cql_ood, n, act), minval=LOW,
                                   maxval=HIGH),
            policy=jax.random.normal(r_pi, (cql_ood * n, act)))
    else:
        noise["critic"] = jax.random.normal(rng_c, (n, act))
    return {k: np.asarray(v) for k, v in noise.items()}


def _td3_draws(key, n, act):
    import jax
    _key, sub = jax.random.split(key)
    return {"target": np.asarray(jax.random.normal(sub, (n, act)))}


def _share_draws(j, t, draw):
    """Record each JAX update's draws (``draw(key, batch size)``) and hand
    them, in order, to the port's updates."""
    draws = []
    j_update, t_update = j.learner.update, t.learner.update

    def recorded(batch):
        draws.append(draw(j.learner._key, len(batch)))
        return j_update(batch)

    j.learner.update = recorded
    t.learner.update = lambda batch: t_update(batch, noise=draws.pop(0))
    return draws


def _scale_actor(ckpt):
    """The checkpoint with the actor's last layer scaled by 0.1 (R-5)."""
    import jax
    state = jax.tree_util.tree_map(lambda x: x, ckpt["state"])
    last = state["actor"]["net"][-1]
    last["w"], last["b"] = last["w"] * 0.1, last["b"] * 0.1
    return {**ckpt, "state": state}


def _buffer(algo):
    return concat_samples(algo.buffer._batches)


def _continuous(mod, name, **training):
    cfg = small(getattr(mod, name)())
    return cfg.training(random_warmup_steps=1000, train_batch_size=32,
                        grad_steps_per_iter=GRAD_STEPS, **training)


SAC_LRS = {"actor": 3e-4, "critic": 1e-3, "alpha": 3e-3}


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_sac_matches_jax(cluster, per):
    import ray_tpu.rllib as J

    def cfg(mod):
        return _continuous(mod, "SACConfig", prioritized_replay=per,
                           actor_lr=3e-4, critic_lr=1e-3, alpha_lr=3e-3,
                           initial_alpha=0.5)

    with pair(cfg(J), cfg(R), prepare=_scale_actor) as (j, t):
        act = t.learner._action_dim
        draws = _share_draws(j, t, lambda k, n: _sac_draws(k, n, act))
        rj, rt = train_both(j, t)
        assert not draws
        results_match(rj, rt)
        bj, bt = _buffer(j), _buffer(t)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
        _state_matches(t.learner, j.learner, SAC_LRS,
                       {"actor": 2 * GRAD_STEPS, "critic": 2 * GRAD_STEPS})


@pytest.mark.parametrize("name", ["TD3Config", "DDPGConfig"])
def test_td3_ddpg_match_jax(cluster, name):
    """TD3 steps its actor (and both targets) on every second update,
    DDPG on every update: the counter and the actor's Adam steps agree."""
    import ray_tpu.rllib as J

    def cfg(mod):
        return _continuous(mod, name)

    with pair(cfg(J), cfg(R)) as (j, t):
        act = t.learner._action_dim
        _share_draws(j, t, lambda k, n: _td3_draws(k, n, act))
        rj, rt = train_both(j, t)
        results_match(rj, rt)
        updates = 2 * GRAD_STEPS
        assert t.learner.steps == int(j.learner.state["steps"]) == updates
        delay = t.algo_config.policy_delay
        _state_matches(t.learner, j.learner, {"actor": 1e-3, "critic": 1e-3},
                       {"actor": updates // delay, "critic": updates})


def _write_offline(path, env, n=96, seed=0):
    """A dataset of ``n`` random transitions of ``env`` through the
    port's JsonWriter, in three fragments."""
    rng = np.random.default_rng(seed)
    w = R.JsonWriter(str(path))
    for f in range(3):
        m = n // 3
        if env == "Pendulum-v1":
            cols = {"obs": rng.standard_normal((m, 3)),
                    "actions": rng.uniform(LOW, HIGH, (m, 1)),
                    "next_obs": rng.standard_normal((m, 3))}
        else:
            cols = {"obs": rng.standard_normal((m, 4)) * 0.1,
                    "actions": rng.integers(0, 2, m)}
        cols["rewards"] = rng.standard_normal(m)
        cols["terminateds"] = np.arange(m) % 10 == 9
        w.write(SampleBatch({k: np.asarray(v) for k, v in cols.items()}))
    w.close()
    return str(path)


def test_cql_matches_jax(cluster, tmp_path):
    import ray_tpu.rllib as J
    data = _write_offline(tmp_path / "pendulum", "Pendulum-v1")

    def cfg(mod):
        c = mod.CQLConfig().offline_data(input_path=data)
        c.hidden = (16, 16)
        return c.training(train_batch_size=32, num_ood_actions=3,
                          cql_alpha=2.0, actor_lr=3e-4, critic_lr=1e-3,
                          alpha_lr=3e-3).debugging(seed=0)

    with pair(cfg(J), cfg(R), prepare=_scale_actor) as (j, t):
        act = t.learner._action_dim
        _share_draws(j, t, lambda k, n: _sac_draws(k, n, act, cql_ood=3))
        rj, rt = train_both(j, t)
        results_match(rj, rt)
        _state_matches(t.learner, j.learner, SAC_LRS,
                       {"actor": 2, "critic": 2})


@pytest.mark.parametrize("name", ["BCConfig", "MARWILConfig"])
def test_offline_discrete_matches_jax(cluster, tmp_path, name):
    """BC and MARWIL on CartPole rows: the same rows drawn, losses within
    VALUE_TOL, the parameters and Adam moments; MARWIL's running
    advantage norm too."""
    import ray_tpu.rllib as J
    data = _write_offline(tmp_path / "cartpole", "CartPole-v1")

    def cfg(mod):
        c = getattr(mod, name)().offline_data(input_path=data)
        c.hidden = (16, 16)
        return c.training(train_batch_size=32).debugging(seed=0)

    with pair(cfg(J), cfg(R)) as (j, t):
        rj, rt = train_both(j, t)
        results_match(rj, rt)
        assert_adam_update_close(t.learner, j.params, j.opt_state,
                                 t.algo_config.lr, 2)
        if name == "MARWILConfig":
            close(float(t.learner.adv_norm), float(j._adv_norm),
                  what="adv_norm")
        close(t.evaluate(2)["evaluation_reward_mean"],
              j.evaluate(2)["evaluation_reward_mean"], what="evaluate")


def _round_trip_configs(tmp_path):
    pendulum = _write_offline(tmp_path / "p", "Pendulum-v1")
    cartpole = _write_offline(tmp_path / "c", "CartPole-v1")
    q = dict(learning_starts=32, train_batch_size=16)
    return {
        "PPO": R.PPOConfig().training(minibatch_size=32, num_epochs=1),
        "PPO_multi": R.PPOConfig().environment("MultiCartPole").multi_agent(
            policies=["p0", "p1"], policy_mapping_fn=lambda a: f"p{a[-1]}"
        ).training(minibatch_size=32, num_epochs=1),
        "APPO": R.APPOConfig().training(minibatch_size=32,
                                        num_batches_per_step=1),
        "DQN": R.DQNConfig().training(**q),
        "C51": R.C51Config().training(**q),
        "QRDQN": R.QRDQNConfig().training(**q),
        "NoisyDQN": R.NoisyDQNConfig().training(**q),
        "R2D2": R.R2D2Config().training(learning_starts=16,
                                        train_batch_size=2),
        "ApexDQN": R.ApexDQNConfig().training(**q),
        "SAC": R.SACConfig().training(random_warmup_steps=0,
                                      train_batch_size=16,
                                      grad_steps_per_iter=2),
        "TD3": R.TD3Config().training(random_warmup_steps=0,
                                      train_batch_size=16,
                                      grad_steps_per_iter=2),
        "CQL": R.CQLConfig().offline_data(input_path=pendulum).training(
            train_batch_size=16),
        "BC": R.BCConfig().offline_data(input_path=cartpole),
        "MARWIL": R.MARWILConfig().offline_data(input_path=cartpole),
        "ARS": R.ARSConfig().training(num_perturbations=2,
                                      max_episode_steps=20),
    }


def _learner_state(algo):
    """Every array a checkpoint restores, as numpy, by name."""
    out = {}
    learners = getattr(algo, "learners", None) or {
        "": getattr(algo, "learner", None)}
    for pid, ln in learners.items():
        if ln is None:
            continue
        for k, v in ln.get_weights().items():
            out[f"{pid}/{k}"] = v.cpu().numpy()
        if hasattr(ln, "target"):
            for k, v in ln.get_target_weights().items():
                out[f"{pid}/target.{k}"] = v.cpu().numpy()
        if hasattr(ln, "adv_norm"):
            out[f"{pid}/adv_norm"] = ln.adv_norm.cpu().numpy()
    if hasattr(algo, "theta"):
        for k in ("theta", "_m", "_v"):
            out[k] = np.asarray(getattr(algo, k))
    return out


@pytest.mark.parametrize("name", [
    "PPO", "PPO_multi", "APPO", "DQN", "C51", "QRDQN", "NoisyDQN", "R2D2",
    "ApexDQN", "SAC", "TD3", "CQL", "BC", "MARWIL", "ARS"])
def test_checkpoint_round_trip(tmp_path, name):
    """Train one iteration, save, load into a fresh algorithm of another
    seed: every restored array is bit-equal, the iteration carries, and
    the restored algorithm trains on."""
    cfg = _round_trip_configs(tmp_path)[name]
    cfg.hidden = (16, 16)
    cfg.env_runners(num_env_runners=1, rollout_fragment_length=32)
    cfg.resources(device="cpu")
    a = cfg.copy().debugging(seed=1).build()
    b = cfg.copy().debugging(seed=2).build()
    try:
        a.train()
        a.train()
        before = _learner_state(b)
        b.load_checkpoint(a.save_checkpoint())
        sa, sb = _learner_state(a), _learner_state(b)
        assert sorted(sa) == sorted(sb) and sa
        assert any(not np.array_equal(before[k], sb[k]) for k in sb)
        for k in sa:
            np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
        assert b._iteration == a._iteration == 2
        assert b.train()["training_iteration"] == 3
    finally:
        a.stop()
        b.stop()
