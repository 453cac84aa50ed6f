"""Behavior Cloning: the port of ``ray_tpu/rllib/algorithms/bc.py``
(``BCConfig`` :21, ``BC`` :34).

Reference parity: rllib/algorithms/bc/bc.py (BC over the offline
JsonReader pipeline — no environment interaction during training;
evaluation rollouts are opt-in via evaluate()). JAX keeps the update inside
the algorithm; here it is ``BCLearner``: the policy/value MLP at seed
``seed``, optax's adam, and ``training_step``'s row draw
(``RandomState(seed).randint``) as ``sample``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.env_runner import run_policy
from ray_tpu_torch.rllib.learner import Learner, to_tensor
from ray_tpu_torch.rllib.models import (policy_value_apply,
                                        policy_value_init, seeded)
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class BCConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BC)
        self.input_path = ""          # dir of JsonWriter output
        self.train_batch_size = 256
        self.num_env_runners = 0      # offline: no rollout actors

    def offline_data(self, *, input_path=None) -> "BCConfig":
        if input_path is not None:
            self.input_path = input_path
        return self


def taken_logp(logits, actions):
    """log softmax(logits)[rows, actions]."""
    return F.log_softmax(logits, -1).gather(-1, actions[:, None])[:, 0]


class BCLearner(Learner):
    _COLUMNS = (sb.OBS, sb.ACTIONS)

    def __init__(self, obs_dim: int, num_actions: int, *, hidden=(64, 64),
                 lr=5e-4, seed=0, device=None):
        device = resolve_device(device)
        module = policy_value_init(obs_dim, num_actions, tuple(hidden),
                                   generator=seeded(seed), device=device)
        super().__init__(module, lr, device)
        self._rng = np.random.RandomState(seed)

    def sample(self, data: SampleBatch, batch_size: int) -> SampleBatch:
        """``training_step``'s rows: min(batch_size, n) indices drawn with
        replacement from the learner's ``RandomState(seed)``."""
        n = len(data)
        idx = self._rng.randint(0, n, size=min(batch_size, n))
        return SampleBatch({k: data[k][idx] for k in self._COLUMNS})

    def _columns(self, batch):
        return {k: to_tensor(batch[k], self.device) for k in self._COLUMNS}

    def update(self, batch) -> Dict[str, float]:
        c = self._columns(batch)
        logits, _ = policy_value_apply(self.module, c[sb.OBS])
        loss = -taken_logp(logits, c[sb.ACTIONS]).mean()
        self._step(loss)
        return {"loss": float(loss.detach())}


def evaluate(module, env_spec, env_config: dict, seed: int,
             num_episodes: int = 5) -> Dict[str, Any]:
    """Greedy rollouts of a policy/value module on fresh envs seeded
    seed + episode (``BC.evaluate``, ``MARWIL.evaluate``); the forward on
    the module's device, one host read per step."""
    device = next(module.parameters()).device
    env = make_env(env_spec, env_config)
    rewards = []
    for ep in range(num_episodes):
        obs, _ = env.reset(seed=seed + ep)
        total, done = 0.0, False
        while not done:
            logits, _ = run_policy(policy_value_apply, module, device,
                                   np.asarray(obs, np.float32)[None, :])
            obs, r, term, trunc, _ = env.step(int(np.argmax(logits[0])))
            total += r
            done = term or trunc
        rewards.append(total)
    return {"evaluation_reward_mean": float(np.mean(rewards))}


def read_offline(algo) -> JsonReader:
    """The offline algorithms' start: no runners, the input's reader."""
    cfg = algo.algo_config
    if not cfg.input_path:
        raise ValueError(f"{type(algo).__name__} requires "
                         f"config.offline_data(input_path=...)")
    algo.env_runners = []
    algo._episode_rewards = []
    return JsonReader(cfg.input_path, seed=cfg.seed)


class BC(Algorithm):
    config_class = BCConfig

    def setup(self, config: Dict[str, Any]):
        self.data = read_offline(self).read_all()
        self.build_learner()

    def build_learner(self):
        cfg = self.algo_config
        probe = make_env(cfg.env, cfg.env_config)
        self.learner = BCLearner(probe.observation_dim, probe.num_actions,
                                 hidden=cfg.hidden, lr=cfg.lr, seed=cfg.seed,
                                 device=cfg.device)

    def training_step(self) -> Dict[str, Any]:
        batch = self.learner.sample(self.data,
                                    self.algo_config.train_batch_size)
        m = self.learner.update(batch)
        m["num_samples_trained"] = len(batch)
        m["episode_reward_mean"] = float("nan")
        return m

    def evaluate(self, num_episodes: int = 5) -> Dict[str, Any]:
        """Greedy rollouts with the cloned policy."""
        cfg = self.algo_config
        return evaluate(self.learner.module, cfg.env, cfg.env_config,
                        cfg.seed, num_episodes)

    def save_checkpoint(self):
        return {"params": self.learner.get_weights(),
                "iteration": self._iteration}

    def load_checkpoint(self, ckpt):
        self.learner.set_weights(ckpt["params"])
        self._iteration = ckpt.get("iteration", 0)

    def cleanup(self):
        pass
