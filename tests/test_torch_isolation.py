"""The port stands alone: no JAX and nothing of ray_tpu behind it, no
silent CPU fallback for the card, and no nvcc needed to import it."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# The RLlib slices: the numpy copies, then the ports of JAX code, then the
# orchestration (the algorithms and the in-process runtime); then the
# podracer members, serve's _jsonable and Tune's Trainable.
RLLIB_MODULES = ["ray_tpu_torch.rllib." + m for m in (
    "sample_batch", "env", "connectors", "replay_buffer", "models",
    "catalog", "convert", "learner", "algorithms.a2c", "algorithms.pg",
    "env_runner", "algorithms.dqn", "algorithms.c51", "algorithms.qrdqn",
    "algorithms.noisy", "algorithms.r2d2", "offline", "algorithms.sac",
    "algorithms.td3", "algorithms.cql", "algorithms.bc",
    "algorithms.marwil", "local_runtime", "algorithm", "algorithms.ppo",
    "algorithms.impala", "algorithms.appo", "algorithms.apex",
    "algorithms.es")] + ["ray_tpu_torch.podracer.runtime",
                         "ray_tpu_torch.serve.proxy",
                         "ray_tpu_torch.tune.trainable"]


# The Train harness (JaxTrainer's counterpart) and the in-process runtime
# it shares with RLlib.
TRAIN_MODULES = ["ray_tpu_torch.train." + m for m in (
    "config", "session", "worker_group", "backend_executor", "trainer")] + [
    "ray_tpu_torch.util.local_runtime"]
TRAIN_NAMES = [
    "Trainer", "Result", "ScalingConfig", "RunConfig", "CheckpointConfig",
    "FailureConfig", "Checkpoint", "report", "get_checkpoint", "get_context",
    "should_checkpoint", "get_dataset_shard", "BackendConfig",
    "CudaBackendConfig", "BackendExecutor", "WorkerGroup",
    "TrainingFailedError"]


def _all_modules():
    return ["ray_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                              "ray_tpu_torch."))


def test_package_imports_no_jax_and_no_ray_tpu():
    mods = _all_modules()
    assert "ray_tpu_torch.ops.attention" in mods
    assert "ray_tpu_torch.train.train_step" in mods
    assert "ray_tpu_torch.parallel.mesh" in mods
    assert "ray_tpu_torch.parallel.sharding" in mods
    assert set(RLLIB_MODULES) <= set(mods), set(RLLIB_MODULES) - set(mods)
    assert set(TRAIN_MODULES) <= set(mods), set(TRAIN_MODULES) - set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "tops = {m: m.split('.')[0] for m in sys.modules}\n"
        "bad = sorted(m for m, t in tops.items() if t.startswith('jax') "
        "or t in ('optax', 'ray_tpu'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_train_harness_imports_no_jax_and_no_ray_tpu():
    """The harness's names, imported alone in a fresh process, load no
    jax*, optax or ray_tpu module."""
    code = (
        "import sys\n"
        f"from ray_tpu_torch.train import {', '.join(TRAIN_NAMES)}\n"
        f"import {', '.join(TRAIN_MODULES)}\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "bad = sorted(t for t in tops if t.startswith('jax') "
        "or t in ('optax', 'ray_tpu'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
    from ray_tpu_torch import train
    assert set(TRAIN_NAMES) <= set(train.__all__)


def test_default_device_raises_without_cuda(monkeypatch):
    from ray_tpu_torch.models import GPTConfig, gpt_init
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ray_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gpt_init(GPTConfig.tiny())
    assert ray_tpu_torch.resolve_device("cpu").type == "cpu"


def test_rllib_default_device_raises_without_cuda(monkeypatch):
    """Learners and runners built with device=None go to the card, and
    raise without one, as gpt_init does."""
    from ray_tpu_torch.rllib.algorithms.bc import BCLearner
    from ray_tpu_torch.rllib.algorithms.c51 import C51Learner
    from ray_tpu_torch.rllib.algorithms.cql import CQLLearner
    from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner
    from ray_tpu_torch.rllib.algorithms.noisy import NoisyDQNLearner
    from ray_tpu_torch.rllib.algorithms.qrdqn import QRDQNLearner
    from ray_tpu_torch.podracer.runtime import _Learner, _RolloutWorker
    from ray_tpu_torch.rllib.algorithms.marwil import MARWILLearner
    from ray_tpu_torch.rllib.algorithms.r2d2 import (R2D2Learner,
                                                     R2D2Runner)
    from ray_tpu_torch.rllib.algorithms.sac import SACLearner
    from ray_tpu_torch.rllib.algorithms.td3 import TD3Learner
    from ray_tpu_torch.rllib.env_runner import (ContinuousEnvRunner,
                                                EnvRunner,
                                                MultiAgentEnvRunner)
    from ray_tpu_torch.rllib.learner import PPOLearner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builds = [
        lambda: PPOLearner(4, 2),
        lambda: DQNLearner(4, 2),
        lambda: C51Learner(4, 2),
        lambda: QRDQNLearner(4, 2),
        lambda: NoisyDQNLearner(4, 2),
        lambda: R2D2Learner((4,), 2),
        lambda: EnvRunner("CartPole-v1", {}, 1, 0),
        lambda: R2D2Runner("MemoryCue", {}, 1, 0),
        lambda: MultiAgentEnvRunner("MultiCartPole", {}, ["p"],
                                    lambda a: "p"),
        lambda: ContinuousEnvRunner("Pendulum-v1", {}, 1, 0),
        lambda: SACLearner(3, 1, -2.0, 2.0),
        lambda: TD3Learner(3, 1, -2.0, 2.0),
        lambda: CQLLearner(3, 1, -2.0, 2.0),
        lambda: BCLearner(4, 2),
        lambda: MARWILLearner(4, 2),
        lambda: _RolloutWorker("CartPole-v1", {}, 1, 4, 0),
        lambda: _Learner(4, 2, lr=5e-4),
    ]
    for build in builds:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert PPOLearner(4, 2, device="cpu").device.type == "cpu"


def test_algorithms_default_to_the_card(monkeypatch, tmp_path):
    """Every algorithm of ``ray_tpu_torch.rllib`` built from its config
    with no device asks for the card, and raises without one;
    ``resources(device="cpu")`` builds it on the CPU."""
    import numpy as np
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib import JsonWriter, SampleBatch
    w = JsonWriter(str(tmp_path))
    w.write(SampleBatch({"obs": np.zeros((4, 3)), "actions": np.zeros(4),
                         "rewards": np.zeros(4), "next_obs": np.zeros((4, 3)),
                         "terminateds": np.zeros(4, bool)}))
    w.close()
    names = [n for n in rllib.__all__
             if n.endswith("Config") and n != "AlgorithmConfig"]
    assert len(names) == 19, names

    def config(name):
        cfg = getattr(rllib, name)().env_runners(num_env_runners=1)
        if hasattr(cfg, "offline_data"):
            cfg.offline_data(input_path=str(tmp_path))
        return cfg

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        for name in names:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                config(name).build()
    algo = config("PPOConfig").resources(device="cpu").build()
    assert algo.learner.device.type == "cpu"


def test_kernels_import_and_cpu_path_need_no_nvcc(monkeypatch):
    """Without nvcc the wrappers import and CPU tensors take the plain
    versions, while building the kernels raises."""
    from ray_tpu_torch.ops import attention
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    before = {n: k.launches for n, k in attention.KERNELS.items()}
    q = torch.randn(1, 2, 64, 16)
    out = attention.flash_attention(q, q, q, block_q=32, block_k=32)
    assert out.shape == q.shape
    assert {n: k.launches for n, k in attention.KERNELS.items()} == before


def test_build_is_keyed_by_source_hash(monkeypatch, tmp_path):
    """An edit to a CUDA source names a new library (so it is rebuilt)."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    first = _build.library_path("k")
    (src / "k.cu").write_text("// v2\n")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR
