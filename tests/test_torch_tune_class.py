"""Tune over a port class: ``ray_tpu_torch.tune.as_tune_trainable`` runs a
port ``Trainable`` subclass (every port ``Algorithm``) through
``ray_tpu.tune``'s class path (ray_tpu/tune/tuner.py:52), PBT's in-place
reset included.

tests/test_tune.py's ``test_class_trainable_and_stop_criteria`` (:46) and
``test_pbt_exploits`` (:133) run with a JAX Trainable subclass and with
the same class on the port's Trainable, and give the same numbers (PBT's
exploits depend on the trials' timing, so there both meet JAX's bound and
both reset in place). A grid of two port PPO trials equals the same
configs trained outside Tune. One module-scoped ray_tpu cluster; classes
are defined inside the tests so that they travel to the trial actors by
value.
"""

import os
import types

import numpy as np
import pytest
import torch

from ray_tpu_torch.tune import Trainable as PortTrainable
from ray_tpu_torch.tune import as_tune_trainable


@pytest.fixture(scope="module")
def tune():
    import ray_tpu
    from ray_tpu import tune as t
    ray_tpu.init(num_cpus=4, num_tpus=0)
    yield t
    ray_tpu.shutdown()


def _trainable(tune, base):
    """``base``'s subclass as Tune takes it: JAX's class as is, the port's
    through the adapter."""
    return lambda cls: cls if base is tune.Trainable else \
        as_tune_trainable(cls, tune)


@pytest.mark.timeout(120)
def test_class_trainable_and_stop_criteria(tune):
    from ray_tpu.train.config import RunConfig
    seen = []
    for base in (tune.Trainable, PortTrainable):
        class MyTrainable(base):
            def setup(self, config):
                self.acc = 0.0

            def step(self):
                self.acc += self.config["rate"]
                return {"acc": self.acc}

            def save_checkpoint(self):
                return {"acc": self.acc}

            def load_checkpoint(self, ckpt):
                self.acc = ckpt["acc"]

        results = tune.Tuner(
            _trainable(tune, base)(MyTrainable),
            param_space={"rate": tune.grid_search([0.5, 1.0])},
            tune_config=tune.TuneConfig(metric="acc", mode="max"),
            run_config=RunConfig(stop={"training_iteration": 4}),
        ).fit()
        best = results.get_best_result()
        seen.append((best.config, best.metrics, results.errors,
                     [results[i].metrics_history for i in range(2)]))
    assert seen[1] == seen[0]
    assert seen[1][0]["rate"] == 1.0 and seen[1][1]["acc"] == 4.0


@pytest.mark.timeout(120)
def test_pbt_exploits(tune, tmp_path):
    from ray_tpu.train.config import RunConfig
    for base in (tune.Trainable, PortTrainable):
        resets = str(tmp_path / f"{base.__module__}.resets")

        class T(base):
            def setup(self, config):
                self.w = 0.0

            def step(self):
                self.w += self.config["lr"]
                return {"score": self.w}

            def save_checkpoint(self):
                return {"w": self.w}

            def load_checkpoint(self, ckpt):
                self.w = ckpt["w"]

            def reset_config(self, cfg):
                with open(resets, "a") as f:
                    f.write(f"{cfg['lr']}\n")
                return True

        sched = tune.PopulationBasedTraining(
            perturbation_interval=2,
            hyperparam_mutations={"lr": [0.01, 1.0]},
            quantile_fraction=0.5, seed=0)
        results = tune.Tuner(
            _trainable(tune, base)(T),
            param_space={"lr": tune.grid_search([0.01, 1.0])},
            tune_config=tune.TuneConfig(metric="score", mode="max",
                                        scheduler=sched),
            run_config=RunConfig(stop={"training_iteration": 8}),
        ).fit()
        finals = sorted(results[i].metrics["score"]
                        for i in range(len(results)))
        # JAX's bound: the weak trial pulled up by exploiting the strong.
        assert finals[0] > 0.08 * 8, (base, finals)
        assert not results.errors
        # The exploit reused the trial in place (reset_config), and the
        # trial stepped with the new lr.
        assert os.path.exists(resets), base
        assert [r["training_iteration"] for r in
                results[0].metrics_history] == list(range(1, 9))


@pytest.mark.timeout(120)
def test_ppo_grid_matches_training_outside_tune(tune):
    """Two port PPO trials, 2 iterations each: Tune's results equal the
    same configs built and trained in this process."""
    from ray_tpu.train.config import RunConfig
    from ray_tpu_torch.rllib import PPO
    space = {"device": "cpu", "num_env_runners": 1,
             "rollout_fragment_length": 32, "minibatch_size": 32,
             "num_epochs": 2, "hidden": (16, 16)}
    results = tune.Tuner(
        as_tune_trainable(PPO, tune),
        param_space={**space, "lr": tune.grid_search([5e-4, 1e-3])},
        tune_config=tune.TuneConfig(metric="episode_reward_mean",
                                    mode="max"),
        run_config=RunConfig(stop={"training_iteration": 2}),
    ).fit()
    assert not results.errors
    for i, lr in enumerate((5e-4, 1e-3)):
        algo = PPO({**space, "lr": lr})
        want = [algo.step() for _ in range(2)]
        algo.stop()
        got = results[i].metrics_history
        assert results[i].config["lr"] == lr
        assert [sorted(r) for r in got] == [sorted(r) for r in want]
        for g, w in zip(got, want):
            for k, v in w.items():
                np.testing.assert_allclose(g[k], v, rtol=1e-6, atol=1e-9,
                                           err_msg=k)


def test_adapter_delegates_and_checkpoints_on_the_host():
    """The adapter's methods in process, against a stand-in Tune module:
    each delegates to the port instance, and a checkpoint leaves as host
    tensors."""
    from ray_tpu.tune.trainable import Trainable as JaxTrainable
    calls = []

    class Box(PortTrainable):
        def setup(self, config):
            self.w = torch.zeros(2)

        def step(self):
            calls.append(("step", self.training_iteration))
            self.w += self.config["lr"]
            return {"w": float(self.w[0])}

        def save_checkpoint(self):
            return {"params": {"w": self.w.clone()}, "n": 1}

        def load_checkpoint(self, ckpt):
            self.w = ckpt["params"]["w"].clone()

        def reset_config(self, cfg):
            return cfg["lr"] > 0

        def cleanup(self):
            calls.append(("cleanup",))

    cls = as_tune_trainable(Box, types.SimpleNamespace(Trainable=JaxTrainable))
    assert issubclass(cls, JaxTrainable) and cls.__name__ == "Box"
    t = cls({"lr": 1.0})
    assert t.step() == {"w": 1.0}
    t.training_iteration = 1
    ckpt = t.save_checkpoint()
    assert sorted(ckpt) == ["n", "params"] and ckpt["n"] == 1
    assert torch.equal(ckpt["params"]["w"], torch.ones(2))
    assert ckpt["params"]["w"].device.type == "cpu"
    assert t.reset_config({"lr": 2.0}) and t._inner.config == {"lr": 2.0}
    assert not t.reset_config({"lr": -1.0})
    assert t.step() == {"w": 3.0}
    t.load_checkpoint(ckpt)
    assert t.step() == {"w": 3.0}
    t.cleanup()
    assert calls == [("step", 0), ("step", 1), ("step", 1), ("cleanup",)]
