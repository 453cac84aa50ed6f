"""Parity: the port's RLlib learners against ray_tpu.rllib's.

Each case builds the JAX learner (seed 0), moves its parameters (and, for
the value-based learners, its target network) into the port's learner on
the CPU with ``rllib/convert.py``, and runs one ``update`` of both on the
same batch (numpy from a seed) with the same minibatch seed. The metrics,
td errors and losses are held to VALUE_TOL; the parameters after the
update, and Adam's two moments, as ``assert_adam_update_close`` says
(tests/torch_rllib_parity.py): parameters within VALUE_TOL, moments within
GRAD_TOL of each leaf's largest magnitude, with Adam's own exception for
gradients that are rounding noise.
"""

import numpy as np
import pytest

from ray_tpu_torch.rllib import convert
from ray_tpu_torch.rllib import sample_batch as tsb
from ray_tpu_torch.rllib.algorithms import a2c as ta2c
from ray_tpu_torch.rllib.algorithms import c51 as tc51
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import noisy as tnoisy
from ray_tpu_torch.rllib.algorithms import pg as tpg
from ray_tpu_torch.rllib.algorithms import qrdqn as tqr
from ray_tpu_torch.rllib.algorithms import r2d2 as tr2d2
from ray_tpu_torch.rllib import learner as tlearner
from test_torch_rllib_models import jax_noise
from torch_rllib_parity import (assert_adam_update_close, close, np_tree,
                                one_torch_thread)  # noqa: F401

LR = 5e-4


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _rng(seed=0):
    return np.random.default_rng(seed)


def _ppo_batch(n, obs_shape, n_act, seed=0, seq_len=None, cell=8):
    rng = _rng(seed)
    b = {"obs": rng.standard_normal((n, *obs_shape)).astype(np.float32),
         "actions": rng.integers(0, n_act, n),
         "action_logp": (np.log(1.0 / n_act)
                         + rng.normal(0, 0.05, n)).astype(np.float32),
         "advantages": rng.standard_normal(n).astype(np.float32),
         "value_targets": (rng.standard_normal(n) * 3).astype(np.float32)}
    if seq_len:
        done_prev = (rng.random(n) < 0.15).astype(np.float32)
        done_prev[::seq_len] = 0.0
        b["done_prev"] = done_prev
        b["state_in_h"] = (rng.standard_normal((n, cell)) * 0.3).astype(
            np.float32)
        b["state_in_c"] = (rng.standard_normal((n, cell)) * 0.3).astype(
            np.float32)
    return b


PPO_CASES = {
    # name: (obs_shape, n_act, model, batch size, seq_len, minibatch)
    "mlp": ((4,), 2, None, 64, None, 16),
    "cnn": ((5, 5, 1), 4, {"fcnet_hiddens": [16]}, 32, None, 16),
    "lstm": ((2,), 2, {"fcnet_hiddens": [8], "use_lstm": True,
                       "lstm_cell_size": 8}, 32, 8, 16),
}


def _ppo_pair(jcls, tcls, case, **kw):
    obs_shape, n_act, model, n, seq_len, _mb = PPO_CASES[case]
    args = dict(hidden=(16, 16), lr=LR, obs_shape=obs_shape, model=model,
                seq_len=seq_len, seed=0, **kw)
    j = jcls(int(np.prod(obs_shape)), n_act, **args)
    t = tcls(int(np.prod(obs_shape)), n_act, device="cpu", **args)
    convert.load_learner(t, np_tree(j.params))
    return j, t


def _ppo_update_matches(j, t, case, batch=None, epochs=2):
    from ray_tpu.rllib import sample_batch as jsb
    obs_shape, n_act, _m, n, seq_len, mb = PPO_CASES[case]
    b = batch or _ppo_batch(n, obs_shape, n_act, seq_len=seq_len)
    mj = j.update(jsb.SampleBatch(b), minibatch_size=mb, num_epochs=epochs,
                  seed=3)
    mt = t.update(tsb.SampleBatch(b), minibatch_size=mb, num_epochs=epochs,
                  seed=3)
    assert sorted(mj) == sorted(mt)
    assert mt["num_minibatch_updates"] == mj["num_minibatch_updates"] > 0
    for k in mj:
        close(mt[k], mj[k], what=k)
    assert_adam_update_close(t, j.params, j.opt_state, LR,
                             mt["num_minibatch_updates"])


@pytest.mark.parametrize("case", sorted(PPO_CASES))
def test_ppo_update_matches_jax(jx, case):
    from ray_tpu.rllib.learner import PPOLearner
    j, t = _ppo_pair(PPOLearner, tlearner.PPOLearner, case,
                     entropy_coeff=0.01)
    _ppo_update_matches(j, t, case)


@pytest.mark.parametrize("case", ["mlp", "lstm"])
def test_a2c_update_matches_jax(jx, case):
    from ray_tpu.rllib.algorithms.a2c import A2CLearner
    j, t = _ppo_pair(A2CLearner, ta2c.A2CLearner, case, entropy_coeff=0.01)
    _ppo_update_matches(j, t, case)


def test_pg_update_matches_jax(jx):
    """PG's learner on a batch whose advantages are the returns, as
    PG.training_step feeds it, for one epoch."""
    from ray_tpu.rllib.algorithms.pg import PGLearner
    j, t = _ppo_pair(PGLearner, tpg.PGLearner, "mlp")
    b = _ppo_batch(64, (4,), 2)
    b["advantages"] = b["value_targets"]
    _ppo_update_matches(j, t, "mlp", batch=b, epochs=1)


def test_ppo_learner_errors_and_weights():
    with pytest.raises(ValueError, match="needs seq_len"):
        tlearner.PPOLearner(2, 2, model={"use_lstm": True}, device="cpu")
    t = tlearner.PPOLearner(2, 2, model={"use_lstm": True,
                                         "lstm_cell_size": 4},
                            seq_len=8, device="cpu")
    with pytest.raises(ValueError, match="not divisible by seq_len"):
        t.update(tsb.SampleBatch(_ppo_batch(12, (2,), 2, seq_len=8,
                                            cell=4)),
                 minibatch_size=8, num_epochs=1)
    # get_weights is a snapshot: a later update does not move it.
    w = t.get_weights()
    t.update(tsb.SampleBatch(_ppo_batch(16, (2,), 2, seq_len=8, cell=4)),
             minibatch_size=8, num_epochs=1)
    moved = t.get_weights()
    assert any(not np.array_equal(w[k].numpy(), moved[k].numpy())
               for k in w)
    t.set_weights(w)
    for k, v in t.module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), w[k].numpy())


def _q_batch(n, obs_shape, n_act, seed=0, nstep=False, weights=False):
    rng = _rng(seed)
    b = {"obs": rng.standard_normal((n, *obs_shape)).astype(np.float32),
         "actions": rng.integers(0, n_act, n),
         "rewards": rng.standard_normal(n),
         "next_obs": rng.standard_normal((n, *obs_shape)).astype(
             np.float32),
         "terminateds": rng.random(n) < 0.2}
    if nstep:
        b["nstep_gammas"] = 0.99 ** rng.integers(1, 4, n)
    if weights:
        b["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return b


def _q_update_matches(j, t, b, **update_kw):
    from ray_tpu.rllib import sample_batch as jsb
    mj = j.update(jsb.SampleBatch(b))
    mt = t.update(tsb.SampleBatch(b), **update_kw)
    close(mt["loss"], mj["loss"], what="loss")
    close(mt["td_error"], mj["td_error"], what="td_error")
    assert_adam_update_close(t, j.params, j.opt_state, LR, 1)
    # The target network is the pre-update copy, and sync_target takes
    # the updated weights.
    t.sync_target()
    for k, v in t.target.state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      t.module.state_dict()[k].numpy())
        assert not t.target.get_parameter(k).requires_grad


DQN_CASES = {
    "double": dict(double_q=True),
    "single": dict(double_q=False),
    "dueling": dict(dueling=True),
    "nstep_weights": dict(double_q=True),
    "catalog_cnn": dict(model={"fcnet_hiddens": [16]},
                        obs_shape=(5, 5, 1)),
}


@pytest.mark.parametrize("case", sorted(DQN_CASES))
def test_dqn_update_matches_jax(jx, case):
    from ray_tpu.rllib.algorithms.dqn import DQNLearner
    kw = dict(DQN_CASES[case])
    obs_shape = kw.get("obs_shape", (4,))
    n_act = 4 if "model" in kw else 2
    args = dict(hidden=(16, 16), lr=LR, gamma=0.99, seed=0, **kw)
    j = DQNLearner(int(np.prod(obs_shape)), n_act, **args)
    t = tdqn.DQNLearner(int(np.prod(obs_shape)), n_act, device="cpu", **args)
    tree = np_tree(j.params)
    # A target that differs from the online net, as after some updates.
    target = {k: v for k, v in np_tree(j.params).items()}
    import jax
    target = jax.tree_util.tree_map(lambda x: x * 0.9, target)
    j.target_params = target
    convert.load_learner(t, tree, target)
    extra = case == "nstep_weights"
    _q_update_matches(j, t, _q_batch(32, obs_shape, n_act, nstep=extra,
                                     weights=extra))


@pytest.mark.parametrize("double_q", [True, False])
def test_c51_update_matches_jax(jx, double_q):
    from ray_tpu.rllib.algorithms.c51 import C51Learner
    args = dict(hidden=(16,), lr=LR, n_atoms=11, v_min=-5.0, v_max=5.0,
                double_q=double_q, seed=0)
    j = C51Learner(4, 2, **args)
    t = tc51.C51Learner(4, 2, device="cpu", **args)
    convert.load_learner(t, np_tree(j.params))
    _q_update_matches(j, t, _q_batch(32, (4,), 2, nstep=True))


@pytest.mark.parametrize("double_q", [True, False])
def test_qrdqn_update_matches_jax(jx, double_q):
    from ray_tpu.rllib.algorithms.qrdqn import QRDQNLearner
    args = dict(hidden=(16,), lr=LR, n_quantiles=8, kappa=1.0,
                double_q=double_q, seed=0)
    j = QRDQNLearner(4, 2, **args)
    t = tqr.QRDQNLearner(4, 2, device="cpu", **args)
    convert.load_learner(t, np_tree(j.params))
    _q_update_matches(j, t, _q_batch(32, (4,), 2, weights=True))


@pytest.mark.parametrize("double_q", [True, False])
def test_noisy_dqn_update_matches_jax(jx, double_q):
    """The port's update with the three noise draws JAX's update makes
    (its key split into online, target and selection keys)."""
    import jax
    from ray_tpu.rllib.algorithms.noisy import NoisyDQNLearner
    args = dict(hidden=(16,), lr=LR, double_q=double_q, sigma0=0.5, seed=0)
    j = NoisyDQNLearner(4, 2, **args)
    t = tnoisy.NoisyDQNLearner(4, 2, device="cpu", **args)
    convert.load_learner(t, np_tree(j.params))
    _key, *keys = jax.random.split(j._key, 4)
    layers = np_tree(j.params)["q"]
    noise = [jax_noise(layers, k) for k in keys]
    _q_update_matches(j, t, _q_batch(32, (4,), 2), noise=noise)


def _r2d2_batch(b, t, obs_dim, n_act, cell, seed=0):
    rng = _rng(seed)
    dones = np.zeros((b, t), np.float32)
    terms = np.zeros((b, t), np.float32)
    dones[0, 3] = 1.0                   # truncated: no successor obs
    dones[1, 2] = terms[1, 2] = 1.0     # terminated
    dones[2, t - 1] = terms[2, t - 1] = 1.0
    done_prev = np.zeros((b, t), np.float32)
    done_prev[:, 1:] = dones[:, :-1]
    return {"obs": rng.standard_normal((b, t, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, n_act, (b, t)),
            "rewards": rng.standard_normal((b, t)),
            "dones": dones, "terminateds": terms, "done_prev": done_prev,
            "state_in_h": (rng.standard_normal((b, cell)) * 0.3).astype(
                np.float32),
            "state_in_c": (rng.standard_normal((b, cell)) * 0.3).astype(
                np.float32)}


@pytest.mark.parametrize("burn_in,double_q,weights",
                         [(0, True, False), (2, True, True),
                          (0, False, False)])
def test_r2d2_update_matches_jax(jx, burn_in, double_q, weights):
    from ray_tpu.rllib.algorithms.r2d2 import R2D2Learner
    args = dict(hidden=(8,), lstm_cell_size=8, lr=LR, gamma=0.99,
                double_q=double_q, burn_in=burn_in, seed=0)
    j = R2D2Learner((3,), 2, **args)
    t = tr2d2.R2D2Learner((3,), 2, device="cpu", **args)
    convert.load_learner(t, np_tree(j.params))
    b = _r2d2_batch(4, 7, 3, 2, 8)
    if weights:
        b["weights"] = np.array([1.0, 0.5, 0.25, 0.8], np.float32)
    _q_update_matches(j, t, b)


@pytest.mark.parametrize("n", [1, 3])
def test_nstep_transform_matches_jax_exactly(jx, n):
    from ray_tpu.rllib.algorithms.dqn import nstep_transform
    from ray_tpu.rllib import sample_batch as jsb
    rng = _rng(1)
    size = 2 * 20
    b = {"obs": rng.standard_normal((size, 3)).astype(np.float32),
         "actions": rng.integers(0, 2, size),
         "rewards": rng.standard_normal(size),
         "next_obs": rng.standard_normal((size, 3)).astype(np.float32),
         "terminateds": rng.random(size) < 0.1,
         "truncateds": rng.random(size) < 0.1}
    ref = nstep_transform(jsb.SampleBatch(b), n, 0.97, 2)
    out = tdqn.nstep_transform(tsb.SampleBatch(b), n, 0.97, 2)
    assert sorted(ref) == sorted(out)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
