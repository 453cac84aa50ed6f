"""Parity: the port's value-based algorithms (DQN, C51, QR-DQN, Noisy DQN,
R2D2, APEX-DQN), built from their configs, against ray_tpu.rllib's on a
ray_tpu cluster.

Each case starts both algorithms from JAX's converted checkpoint (with
the target network and the sampled-step count) and trains two iterations
(``torch_rllib_algo_parity``): the first iteration passes
``learning_starts`` and updates, the target syncs every iteration. The
tests hold the same metric keys, equal step counts, replay sizes, epsilon,
episodes and returns, the mean loss within VALUE_TOL, and the learner's
parameters, Adam moments and target network at the end.

Noisy DQN draws its noise inside its runners and its update (JAX from its
keys, the port from device generators), so its actions differ: the test
holds what does not depend on a draw — step counts, replay size, epsilon
0, the number of updates and of target syncs.
"""

import numpy as np
import pytest

import ray_tpu_torch.rllib as R
from torch_rllib_algo_parity import (cluster, counting, pair,  # noqa
                                     results_match, small, train_both,
                                     weights_match)
from torch_rllib_parity import (assert_adam_update_close,
                                one_torch_thread)  # noqa: F401

UPDATES = 4


def _q(mod, name, runners=2, fragment=32, **training):
    cfg = small(getattr(mod, name)(), runners=runners, fragment=fragment)
    kw = dict(learning_starts=64, train_batch_size=32,
              updates_per_step=UPDATES, target_network_update_freq=64,
              epsilon_start=0.3, epsilon_end=0.05, epsilon_decay_steps=200)
    return cfg.training(**{**kw, **training})


def _learner_matches(t, j, updates):
    assert_adam_update_close(t.learner, j.learner.params,
                             j.learner.opt_state, t.algo_config.lr, updates)
    weights_match(t.learner.target, j.learner.target_params, "target")
    assert t._steps_sampled == j._steps_sampled


CASES = {
    "dqn": ("DQNConfig", {}),
    "dqn_per_nstep": ("DQNConfig", dict(prioritized_replay=True, n_step=3)),
    "dqn_dueling": ("DQNConfig", dict(dueling=True)),
    "c51": ("C51Config", dict(n_atoms=11, v_min=-5.0, v_max=5.0)),
    "qrdqn": ("QRDQNConfig", dict(n_quantiles=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_q_algorithms_match_jax(cluster, case):
    import ray_tpu.rllib as J
    name, kw = CASES[case]
    with pair(_q(J, name, **kw), _q(R, name, **kw)) as (j, t):
        rj, rt = train_both(j, t)
        results_match(rj, rt)
        assert "loss" in rt[0]
        _learner_matches(t, j, 2 * UPDATES)


def test_r2d2_matches_jax(cluster):
    """Sequences of 16 steps with the sampler's LSTM carry, replayed whole;
    learning starts at 32 stored steps (the first iteration's two
    sequences)."""
    import ray_tpu.rllib as J

    def cfg(mod):
        return _q(mod, "R2D2Config", fragment=16, learning_starts=32,
                  lstm_cell_size=8, train_batch_size=4)

    with pair(cfg(J), cfg(R)) as (j, t):
        rj, rt = train_both(j, t)
        results_match(rj, rt)
        _learner_matches(t, j, 2 * UPDATES)


def test_apex_matches_jax(cluster):
    """The per-worker epsilon ladder, the replay actor made through the
    runtime, updates from the second iteration (the first fills the
    replay actor after its rollouts), fire-and-forget priority updates."""
    import ray_tpu.rllib as J

    def cfg(mod):
        return _q(mod, "ApexDQNConfig", epsilon_start=0.4,
                  epsilon_end=0.0)

    with pair(cfg(J), cfg(R)) as (j, t):
        rj, rt = train_both(j, t)
        results_match(rj, rt)
        assert "loss" not in rt[0] and "loss" in rt[1]
        assert rt[0]["worker_epsilons"][1] < rt[0]["worker_epsilons"][0]
        _learner_matches(t, j, UPDATES)


def _adam_count(learner):
    steps = {int(st["step"]) for st in learner.optimizer.state.values()}
    assert len(steps) == 1, steps
    return steps.pop()


def test_noisy_dqn_deterministic_parts_match_jax(cluster):
    import ray_tpu.rllib as J

    def cfg(mod):
        return _q(mod, "NoisyDQNConfig", epsilon_start=0.0,
                  epsilon_end=0.0, sigma0=0.5)

    with pair(cfg(J), cfg(R)) as (j, t):
        syncs = [counting(a.learner, "sync_target") for a in (j, t)]
        rj, rt = train_both(j, t)
        results_match(rj, rt, skip=(
            "loss", "episode_reward_mean", "episodes_total"))
        for r in rt:
            assert r["epsilon"] == 0.0 and np.isfinite(r["loss"])
        assert _adam_count(t.learner) == int(
            j.learner.opt_state[0].count) == 2 * UPDATES
        assert len(syncs[0]) == len(syncs[1]) == 2
        assert t._steps_sampled == j._steps_sampled == 128
