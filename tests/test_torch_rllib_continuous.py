"""Parity: the port's continuous-control compute (ContinuousEnvRunner, SAC,
TD3/DDPG, CQL) against ray_tpu.rllib's.

JAX draws its noise from its PRNG inside the runner and the jitted
updates; each case rebuilds those draws from the JAX object's key, split
as the JAX code splits it, and passes them to the port (``noise=``). The
port's runners and learners start from the JAX weights and state
(``rllib/convert.py``). Bounds are tests/torch_rllib_parity.py's: values
within VALUE_TOL; Adam's moments within GRAD_TOL of each leaf's largest
magnitude; parameters within VALUE_TOL, with Adam's rounding-noise
exception.

The runners' transitions: the warm-up's uniform actions come from numpy in
both packages, so every row before the first policy action is identical.
From there the actions are the two frameworks' fp32 forwards of the same
weights and draws, which differ in the last bit (XLA's tanh and matmul
against torch's): rows are held to VALUE_TOL, terminations exactly.
"""

import types

import numpy as np
import pytest

from ray_tpu_torch.rllib import convert
from ray_tpu_torch.rllib import env_runner as ter
from ray_tpu_torch.rllib.algorithms import cql as tcql
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.algorithms import td3 as ttd3
from torch_rllib_parity import (assert_adam_update_close, close,
                                grads_close, np_tree,
                                one_torch_thread)  # noqa: F401

OBS, ACT, LOW, HIGH = 3, 2, -2.0, 2.0
B = 32
HIDDEN = (16, 16)
SQUASH_SCALE = 0.1


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _runner_noise(key, steps, num_envs, action_dim):
    """The runner's standard normals for ``steps`` policy steps: JAX splits
    its key once per step and draws [num_envs, action_dim] from the sub."""
    import jax
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (num_envs,
                                                      action_dim))))
    return out


@pytest.mark.parametrize("policy", ["squashed_gaussian", "deterministic"])
def test_continuous_runner_matches_jax(jx, policy):
    """Two fragments of Pendulum (15-step episodes, 2 envs): the first
    crosses the warm-up boundary after 5 steps, the second continues the
    envs under the policy."""
    from ray_tpu.rllib.env_runner import ContinuousEnvRunner
    args = ("Pendulum-v1", {"max_steps": 15}, 2, 5)
    kw = dict(hidden=(16,), policy=policy, expl_noise=0.3)
    j = ContinuousEnvRunner(*args, **kw)
    t = ter.ContinuousEnvRunner(*args, device="cpu", **kw)
    t.set_weights(convert.params_from_jax(np_tree(j._params)))
    warm, steps = 5, 12
    for done in (0, 2 * steps):
        policy_steps = sum(done + s >= warm for s in range(steps))
        noise = _runner_noise(j._key, policy_steps, 2, 1)
        bj = j.sample_transitions(steps, warm, done)
        bt = t.sample_transitions(steps, warm, done, noise=noise)
        assert sorted(bt) == sorted(bj)
        exact = 2 * max(0, warm - done)
        for k in bj:
            a, b = np.asarray(bt[k]), np.asarray(bj[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a[:exact], b[:exact], err_msg=k)
            if k == "terminateds":
                np.testing.assert_array_equal(a, b)
            else:
                close(a, b, what=k)
    rj, rt = j.episode_rewards(), t.episode_rewards()
    assert len(rj) == len(rt) == 2
    close(rt, rj, what="episode rewards")


def test_continuous_runner_own_draws():
    """Without injected noise the runner draws from its own generator:
    the same seed gives the same fragment, and warm-up actions are
    uniform in the action range."""
    a, b = (ter.ContinuousEnvRunner("Pendulum-v1", {}, 2, 3, hidden=(8,),
                                    device="cpu") for _ in range(2))
    b.set_weights(a.module.state_dict())
    fa, fb = (r.sample_transitions(10, 4) for r in (a, b))
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
    assert np.all(np.abs(fa["actions"]) <= 2.0)
    with pytest.raises(AssertionError, match="continuous env"):
        ter.ContinuousEnvRunner("CartPole-v1", {}, 1, 0, device="cpu")


def _batch(seed, per=False):
    rng = np.random.default_rng(seed)
    b = {"obs": rng.standard_normal((B, OBS)).astype(np.float32),
         "actions": rng.uniform(LOW, HIGH, (B, ACT)).astype(np.float32),
         "rewards": rng.standard_normal(B),
         "next_obs": rng.standard_normal((B, OBS)).astype(np.float32),
         "terminateds": rng.random(B) < 0.2}
    if per:
        b["weights"] = rng.uniform(0.2, 1.0, B).astype(np.float32)
    return b


def _sac_noise(key, cql_ood=0):
    """The draws of one SAC (or CQL) update from the learner's key: the
    update splits it into the critic's and the actor's keys (CQL splits
    the critic's into four)."""
    import jax
    _key, sub = jax.random.split(key)
    rng_c, rng_a = jax.random.split(sub)
    noise = {"actor": jax.random.normal(rng_a, (B, ACT))}
    if cql_ood:
        r_td, r_ood, r_pi, _ = jax.random.split(rng_c, 4)
        noise.update(
            critic=jax.random.normal(r_td, (B, ACT)),
            ood=jax.random.uniform(r_ood, (cql_ood, B, ACT), minval=LOW,
                                   maxval=HIGH),
            policy=jax.random.normal(r_pi, (cql_ood * B, ACT)))
    else:
        noise["critic"] = jax.random.normal(rng_c, (B, ACT))
    return {k: np.asarray(v) for k, v in noise.items()}


def _td3_noise(key):
    import jax
    _key, sub = jax.random.split(key)
    return {"target": np.asarray(jax.random.normal(sub, (B, ACT)))}


def _pair(jcls, tcls, **kw):
    """A JAX learner and a port learner holding its state. The squashed-
    Gaussian actor's last layer is scaled by SQUASH_SCALE in both: at JAX's
    init the samples reach |pre-tanh| of 11, where JAX's fp32 log-det term
    carries errors up to 0.4 (R-5, ``test_squash_log_det_is_accurate``);
    scaled, |pre| stays under about 4 and JAX's error under 2e-4 per
    element, which the batch means average below VALUE_TOL."""
    j = jcls(OBS, ACT, LOW, HIGH, hidden=HIDDEN, seed=0, **kw)
    if "log_alpha" in j.state:
        last = j.state["actor"]["net"][-1]
        last["w"], last["b"] = (v * SQUASH_SCALE for v in (last["w"],
                                                           last["b"]))
    t = tcls(OBS, ACT, LOW, HIGH, hidden=HIDDEN, seed=0, device="cpu", **kw)
    t.set_weights(convert.params_from_jax(np_tree(j.state)))
    return j, t


def _state_matches(t, j, lrs, steps):
    """Every network of the state, the targets, log_alpha, and Adam's
    moments per part, against the JAX learner's."""
    from torch_rllib_parity import flat
    for part, lr in lrs.items():
        if part == "alpha":
            adam = j.opt_state["alpha"][0]
            p = t.module.log_alpha
            st = t.optimizers["alpha"].state[p]
            close(p.detach().numpy(), np.asarray(j.state["log_alpha"]),
                  what="log_alpha")
            grads_close(st["exp_avg"].numpy(), np.asarray(adam.mu),
                        "alpha exp_avg")
            grads_close(st["exp_avg_sq"].numpy(), np.asarray(adam.nu),
                        "alpha exp_avg_sq")
            continue
        shim = types.SimpleNamespace(module=getattr(t.module, part),
                                     optimizer=t.optimizers[part])
        assert_adam_update_close(shim, j.state[part], j.opt_state[part],
                                 lr, steps[part])
    for name in ("target_actor", "target_critic"):
        if name in j.state:
            ref = flat(j.state[name])
            for k, v in getattr(t.module, name).state_dict().items():
                close(v.numpy(), ref[k], what=(name, k))


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_sac_updates_match_jax(jx, per):
    from ray_tpu.rllib import sample_batch as jsb
    from ray_tpu.rllib.algorithms.sac import SACLearner
    from ray_tpu_torch.rllib import sample_batch as tsb
    j, t = _pair(SACLearner, tsac.SACLearner, actor_lr=3e-4,
                 critic_lr=1e-3, alpha_lr=3e-3, initial_alpha=0.5)
    for step in range(3):
        b = _batch(step, per)
        noise = _sac_noise(j._key)
        mj = j.update(jsb.SampleBatch(b))
        mt = t.update(tsb.SampleBatch(b), noise=noise)
        assert sorted(mt) == sorted(mj)
        for k in mj:
            close(mt[k], mj[k], what=(step, k))
        close(t.last_td_error, j.last_td_error, what="td")
    _state_matches(t, j, {"actor": 3e-4, "critic": 1e-3, "alpha": 3e-3},
                   {"actor": 3, "critic": 3})
    # get_actor_weights is the runner's state dict, a snapshot.
    w = t.get_actor_weights()
    runner = ter.ContinuousEnvRunner("Pendulum-v1", {}, 1, 0,
                                     hidden=HIDDEN, device="cpu")
    assert sorted(w) == sorted(runner.module.state_dict())
    t.update(tsb.SampleBatch(_batch(9)))
    assert not np.array_equal(w["net.0.w"].numpy(),
                              t.module.actor.net[0].w.detach().numpy())


@pytest.mark.parametrize("kind", ["td3", "ddpg"])
def test_td3_updates_match_jax(jx, kind):
    """TD3 with policy_delay 2: the first update steps the critic alone,
    the second the actor and both targets too, the third the critic
    alone. DDPG is the same learner with its defaults."""
    from ray_tpu.rllib import sample_batch as jsb
    from ray_tpu.rllib.algorithms.td3 import TD3Learner
    from ray_tpu_torch.rllib import sample_batch as tsb
    kw = (dict(policy_delay=2, target_noise=0.4, target_noise_clip=0.3)
          if kind == "td3" else dict(ttd3.DDPG_DEFAULTS))
    j, t = _pair(TD3Learner, ttd3.TD3Learner, actor_lr=1e-3,
                 critic_lr=1e-3, **kw)
    actor0 = t.get_actor_weights()
    for step in range(3):
        b = _batch(10 + step)
        noise = _td3_noise(j._key)
        mj = j.update(jsb.SampleBatch(b))
        mt = t.update(tsb.SampleBatch(b), noise=noise)
        assert sorted(mt) == sorted(mj)
        for k in mj:
            close(mt[k], mj[k], what=(step, k))
        moved = not np.array_equal(actor0["net.0.w"].numpy(),
                                   t.module.actor.net[0].w.detach().numpy())
        assert moved == (kind == "ddpg" or step >= 1), step
        assert (mt["actor_loss"] == 0.0) == (kind == "td3" and step != 1)
    assert t.steps == int(j.state["steps"]) == 3
    actor_steps = 1 if kind == "td3" else 3
    _state_matches(t, j, {"actor": 1e-3, "critic": 1e-3},
                   {"actor": actor_steps, "critic": 3})
    w = t.get_weights()
    assert int(w["steps"]) == 3
    fresh = ttd3.TD3Learner(OBS, ACT, LOW, HIGH, hidden=HIDDEN, seed=1,
                            device="cpu", **kw)
    fresh.set_weights(w)
    assert fresh.steps == 3


def test_cql_updates_match_jax(jx):
    """CQL with 3 OOD actions a state: the 2n x B sampled actions through
    the critics in one call, logsumexp over the sample axis."""
    from ray_tpu.rllib import sample_batch as jsb
    from ray_tpu.rllib.algorithms.cql import CQLLearner
    from ray_tpu_torch.rllib import sample_batch as tsb
    n = 3
    j, t = _pair(CQLLearner, tcql.CQLLearner, actor_lr=3e-4,
                 critic_lr=1e-3, alpha_lr=3e-3, cql_alpha=2.0,
                 num_ood_actions=n)
    for step in range(3):
        b = _batch(20 + step)
        noise = _sac_noise(j._key, cql_ood=n)
        mj = j.update(jsb.SampleBatch(b))
        mt = t.update(tsb.SampleBatch(b), noise=noise)
        assert sorted(mt) == sorted(mj)
        for k in mj:
            close(mt[k], mj[k], what=(step, k))
    _state_matches(t, j, {"actor": 3e-4, "critic": 1e-3, "alpha": 3e-3},
                   {"actor": 3, "critic": 3})
    # The port's own draws have JAX's shapes and ranges.
    own = t.draw_noise(B)
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: v.shape for k, v in noise.items()}
    assert float(own["ood"].min()) >= LOW and float(own["ood"].max()) <= HIGH


def test_squash_log_det_is_accurate(jx):
    """R-5: the squashed Gaussian's log |d tanh/d pre| term, log(1 -
    tanh(pre)^2 + 1e-6), against float64. JAX's fp32 form cancels: its
    error passes VALUE_TOL at |pre| near 2.5 and reaches 0.4 past 6. The
    port's form (``tanh_slope``) stays within 1e-6 everywhere, and agrees
    with JAX's within VALUE_TOL where JAX's is accurate."""
    import jax
    import jax.numpy as jnp
    import torch
    from ray_tpu_torch.rllib.models import tanh_slope
    x = np.linspace(-12.0, 12.0, 4801).astype(np.float32)
    ref = np.log(1.0 - np.tanh(x.astype(np.float64)) ** 2 + 1e-6)
    port = torch.log(tanh_slope(torch.from_numpy(x)) + 1e-6).numpy()
    ref_jax = np.asarray(jax.jit(
        lambda v: jnp.log(1 - jnp.tanh(v) ** 2 + 1e-6))(x))
    assert np.abs(port - ref).max() < 1e-6
    calm = np.abs(x) <= 2.0
    close(port[calm], ref_jax[calm], what="|pre| <= 2")
    assert np.abs(ref_jax - ref)[np.abs(x) >= 6.0].max() > 0.1
