"""Parity: the port's on-policy algorithms (PPO, A2C, PG, IMPALA, APPO,
multi-agent PPO), ES and ARS, built from their configs, against
ray_tpu.rllib's on a ray_tpu cluster; the runtime seam; config checks.

Each case starts both algorithms from JAX's converted checkpoint and
trains two iterations (``torch_rllib_algo_parity``): the same metric keys,
equal step counts, episodes and episode returns (the runners drew the same
actions), losses within VALUE_TOL, and the learner's parameters and Adam
moments at the end within the bounds of ``tests/torch_rllib_parity.py``.
IMPALA and APPO run one runner: with two, JAX consumes whichever rollout
lands first, which is not deterministic; the port's two-runner order is
held to submission order on its own.
"""

import numpy as np
import pytest

import ray_tpu_torch.rllib as R
from ray_tpu_torch.rllib import local_runtime
from torch_rllib_algo_parity import (cluster, pair, results_match,  # noqa
                                     small, train_both)
from torch_rllib_parity import (assert_adam_update_close, close,
                                one_torch_thread)  # noqa: F401


def _onpolicy(mod, name, **training):
    cfg = getattr(mod, name)()
    return small(cfg).training(minibatch_size=32, num_epochs=2, **training)


@pytest.mark.parametrize("name", ["PPOConfig", "A2CConfig", "PGConfig"])
def test_onpolicy_matches_jax(cluster, name):
    import ray_tpu.rllib as J
    with pair(_onpolicy(J, name), _onpolicy(R, name)) as (j, t):
        rj, rt = train_both(j, t)
        results_match(rj, rt)
        steps = sum(r["num_minibatch_updates"] for r in rt)
        assert_adam_update_close(t.learner, j.learner.params,
                                 j.learner.opt_state, t.algo_config.lr,
                                 steps)


@pytest.mark.parametrize("name", ["ImpalaConfig", "APPOConfig"])
def test_async_matches_jax_one_runner(cluster, name):
    """Two batches an iteration, weights pushed after every batch, over
    one runner: the re-dispatched rollout of each batch runs with the
    weights its runner held when it was queued."""
    import ray_tpu.rllib as J

    def cfg(mod):
        c = small(getattr(mod, name)(), runners=1).training(
            minibatch_size=32, num_batches_per_step=2, broadcast_interval=1)
        if name == "APPOConfig":
            c.training(target_update_frequency=1)
        return c

    with pair(cfg(J), cfg(R)) as (j, t):
        rj, rt = train_both(j, t)
        results_match(rj, rt)
        steps = (1 if name == "ImpalaConfig" else 2) * 2 * 2
        assert_adam_update_close(t.learner, j.learner.params,
                                 j.learner.opt_state, t.algo_config.lr,
                                 steps)


def _two_policies(mod):
    return (small(mod.PPOConfig().environment("MultiCartPole"))
            .multi_agent(policies=["p0", "p1"],
                         policy_mapping_fn=lambda a: f"p{a[-1]}")
            .training(minibatch_size=32, num_epochs=2))


def test_multi_agent_ppo_matches_jax(cluster):
    """Two policies on MultiCartPole: one learner per policy (seed offset
    j), policy-keyed weights and metrics."""
    import ray_tpu.rllib as J
    with pair(_two_policies(J), _two_policies(R),
              multi_agent=True) as (j, t):
        rj, rt = train_both(j, t)
        results_match(rj, rt)
        assert {k.split("/")[0] for k in rt[0] if "/" in k} == {"p0", "p1"}
        for pid in ("p0", "p1"):
            steps = sum(r[f"{pid}/num_minibatch_updates"] for r in rt)
            ln, jl = t.learners[pid], j.learners[pid]
            assert_adam_update_close(ln, jl.params, jl.opt_state,
                                     t.algo_config.lr, steps)


@pytest.mark.parametrize("name", ["ESConfig", "ARSConfig"])
def test_es_matches_jax(cluster, name):
    """Antithetic perturbations rebuilt from seeds on both sides: the same
    returns, centered ranks (or top directions) and flat theta."""
    import ray_tpu.rllib as J

    def cfg(mod):
        c = small(getattr(mod, name)()).training(num_perturbations=4,
                                                 max_episode_steps=60)
        if name == "ARSConfig":
            c.training(top_directions=2)
        return c

    with pair(cfg(J), cfg(R)) as (j, t):
        rj, rt = train_both(j, t)
        results_match(rj, rt)
        close(t.theta, np.asarray(j.theta), what="theta")
        assert t._t == j._t == 2


def test_injected_runtime_matches_in_process(cluster):
    """``build(runtime=ray_tpu)``: the port's runners are ray_tpu actors
    (torch in worker processes, weights in as host tensors) and the run
    equals the same PPO in process, iteration for iteration."""
    cfg = _onpolicy(R, "PPOConfig").resources(device="cpu")
    remote = cfg.copy().build(runtime=cluster)
    local = cfg.copy().build()
    try:
        assert not remote.in_process and local.in_process
        assert type(remote.env_runners[0]).__module__.startswith("ray_tpu.")
        for _ in range(2):
            a, b = remote.train(), local.train()
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_equal(a[k], b[k], err_msg=k)
        for k, v in remote.learner.get_weights().items():
            np.testing.assert_array_equal(
                v.numpy(), local.learner.get_weights()[k].numpy(), k)
    finally:
        remote.stop()
        local.stop()


def test_local_runtime_keeps_submission_order():
    """IMPALA over two in-process runners: batches are consumed in
    submission order (runner 0, 1, 0, 1), each re-dispatched at once, and
    the weight pushes land after the re-dispatched rollouts."""
    cfg = small(R.ImpalaConfig()).training(
        minibatch_size=32, num_batches_per_step=4,
        broadcast_interval=2).resources(device="cpu")
    algo = cfg.build()
    log = []
    for i, handle in enumerate(algo.env_runners):
        runner = handle._obj
        for name, tag in (("sample", "s"), ("set_weights", "w")):
            fn = getattr(runner, name)

            def logged(*a, _fn=fn, _tag=f"{tag}{i}", **kw):
                log.append(_tag)
                return _fn(*a, **kw)
            setattr(runner, name, logged)
    algo.train()
    # Setup primed s0 and s1. Batch 1 takes s0 and re-dispatches it;
    # batch 2 takes s1 (the older ref), re-dispatches it, and pushes
    # weights to both; batches 3 and 4 repeat.
    assert log == ["s0", "s1", "w0", "w1"] * 2, log
    algo.stop()


def test_local_runtime_surface():
    """get unwraps refs and raises a call's error there, as an actor's
    error surfaces; wait keeps submission order; kill is a no-op."""
    class Box:
        def __init__(self, v):
            self.v = v

        def read(self):
            return self.v

        def fail(self):
            raise KeyError("boom")

    handle = local_runtime.remote(num_cpus=1)(Box).remote(3)
    r1, bad, r2 = (handle.read.remote(), handle.fail.remote(),
                   handle.read.remote())
    assert local_runtime.get(r1) == 3
    assert local_runtime.get([r1, r2]) == [3, 3]
    with pytest.raises(KeyError, match="boom"):
        local_runtime.get(bad)
    done, rest = local_runtime.wait([r2, r1], num_returns=1)
    assert done == [r1] and rest == [r2]
    local_runtime.kill(handle)
    assert local_runtime.get(handle.read.remote()) == 3


def _bad_configs(mod):
    """(what, a config whose build must raise) for every check that runs
    before a runner exists."""
    cases = [
        ("c51 catalog keys", mod.C51Config().training(
            model={"conv_filters": [[4, [2, 2], 1]], "fcnet_hiddens": [8]})),
        ("dqn dueling + catalog", mod.DQNConfig().training(
            model={"fcnet_hiddens": [8]}, dueling=True)),
        ("dqn lstm", mod.DQNConfig().training(
            model={"use_lstm": True})),
        ("r2d2 dueling", mod.R2D2Config().training(dueling=True)),
        ("r2d2 n_step", mod.R2D2Config().training(n_step=3)),
        ("bc input", mod.BCConfig()),
        ("marwil input", mod.MARWILConfig()),
        ("cql input", mod.CQLConfig()),
    ]
    unbound = mod.AlgorithmConfig()
    return cases + [("unbound", unbound)]


def test_validate_config_messages_match_jax(jax_cpu):
    """Every driver-side config rejection raises JAX's ValueError with
    JAX's message, before any runner is made (no cluster is up)."""
    import ray_tpu.rllib as J
    for (what, jcfg), (_, tcfg) in zip(_bad_configs(J), _bad_configs(R)):
        with pytest.raises(ValueError) as je:
            jcfg.build()
        with pytest.raises(ValueError) as te:
            tcfg.resources(device="cpu").build()
        assert str(te.value) == str(je.value), what



def test_tune_function_trainable_runs_port_algorithm(cluster):
    """ray_tpu's Tuner runs a port algorithm inside a function trainable
    (a class trainable must subclass ray_tpu's own Trainable). The
    function is defined here so that it ships by value to the trial
    actors."""
    from ray_tpu import tune

    def trainable(config):
        from ray_tpu import tune
        from ray_tpu_torch.rllib import PPOConfig
        algo = (PPOConfig().env_runners(num_env_runners=1,
                                        rollout_fragment_length=32)
                .training(lr=config["lr"], minibatch_size=32, num_epochs=1)
                .resources(device="cpu").build())
        try:
            for _ in range(2):
                r = algo.train()
                tune.report({"steps": r["num_env_steps_sampled"],
                             "loss": r["total_loss"]})
        finally:
            algo.stop()

    grid = tune.Tuner(trainable,
                      param_space={"lr": tune.grid_search([1e-3, 5e-4])},
                      tune_config=tune.TuneConfig(metric="loss",
                                                  mode="min")).fit()
    results = [r.metrics for r in grid]
    assert len(results) == 2
    for m in results:
        assert m["training_iteration"] == 2 and m["steps"] == 32
        assert np.isfinite(m["loss"])
