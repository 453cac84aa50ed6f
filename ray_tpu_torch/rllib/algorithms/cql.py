"""CQL: the port of ``ray_tpu/rllib/algorithms/cql.py`` (``CQLConfig`` :26,
``CQLLearner`` :60, ``CQL`` :204).

Reference parity: rllib/algorithms/cql/cql.py (+ cql_torch_policy loss —
Kumar et al. 2020): SAC machinery trained purely from an offline dataset,
with a conservative regularizer that pushes down Q on out-of-distribution
actions (logsumexp over sampled actions) and up on dataset actions. The
algorithm's loop (``CQL.training_step``): rows drawn from the
``offline.JsonReader`` data by ``RandomState(seed).randint``, one update
each.

The 2n x B sampled actions (n uniform and n from the policy per state)
go through the twin critics as one batched call over a leading sample
axis, and the logsumexp runs over that axis (``_sample_lse``), as JAX's
``vmap`` and ``logsumexp(axis=0)`` do. The draws (``draw_noise``): the TD
target's and the actor's standard normals [B, A], the uniform actions
[n, B, A] in [low, high] and the policy samples' standard normals
[n B, A].
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.bc import read_offline
from ray_tpu_torch.rllib.algorithms.sac import (SACLearner,
                                                transition_columns)
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.models import twin_q_apply
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class CQLConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or CQL)
        self.env = "Pendulum-v1"
        self.input_path = ""
        self.tau = 0.005
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.initial_alpha = 1.0
        self.target_entropy = None
        self.cql_alpha = 1.0            # conservative penalty weight
        self.num_ood_actions = 4        # sampled actions per state for lse
        self.train_batch_size = 256
        self.num_env_runners = 0        # offline: no rollout actors

    def offline_data(self, *, input_path=None) -> "CQLConfig":
        if input_path is not None:
            self.input_path = input_path
        return self

    def training(self, *, tau=None, actor_lr=None, critic_lr=None,
                 alpha_lr=None, cql_alpha=None, num_ood_actions=None,
                 **kw) -> "CQLConfig":
        super().training(**kw)
        for name, v in (("tau", tau), ("actor_lr", actor_lr),
                        ("critic_lr", critic_lr), ("alpha_lr", alpha_lr),
                        ("cql_alpha", cql_alpha),
                        ("num_ood_actions", num_ood_actions)):
            if v is not None:
                setattr(self, name, v)
        return self


def _sample_lse(q):
    """logsumexp of [2n, B] critic values over the sample axis -> [B]."""
    return torch.logsumexp(q, dim=0)


class CQLLearner(SACLearner):
    """SAC's update with the conservative penalty in the critic loss."""

    _METRICS = ("critic_loss", "actor_loss", "cql_gap", "mean_q", "alpha")

    def __init__(self, obs_dim: int, action_dim: int, low: float,
                 high: float, *, hidden=(64, 64), actor_lr=3e-4,
                 critic_lr=3e-4, alpha_lr=3e-4, gamma=0.99, tau=0.005,
                 initial_alpha=1.0, target_entropy=None, cql_alpha=1.0,
                 num_ood_actions=4, seed=0, device=None):
        super().__init__(obs_dim, action_dim, low, high, hidden=hidden,
                         actor_lr=actor_lr, critic_lr=critic_lr,
                         alpha_lr=alpha_lr, gamma=gamma, tau=tau,
                         initial_alpha=initial_alpha,
                         target_entropy=target_entropy, seed=seed,
                         device=device)
        self._cql_alpha = cql_alpha
        self._n_ood = num_ood_actions

    def draw_noise(self, n: int) -> Dict[str, torch.Tensor]:
        a, k = self._action_dim, self._n_ood
        ood = torch.rand((k, n, a), generator=self._gen, device=self.device)
        return {"critic": self._randn(n, a),
                "ood": self._low + ood * (self._high - self._low),
                "policy": self._randn(k * n, a),
                "actor": self._randn(n, a)}

    def _columns(self, batch):
        return transition_columns(batch, self.device)

    def _critic_loss(self, c, noise):
        """-> (loss, mean Q, the conservative gap)."""
        obs = c[sb.OBS]
        target = self._td_target(c, noise["critic"])
        critic = self.module.critic
        q1, q2 = twin_q_apply(critic, obs, c[sb.ACTIONS])
        td = ((q1 - target) ** 2 + (q2 - target) ** 2).mean()

        # conservative regularizer: logsumexp over OOD actions
        k, b = self._n_ood, obs.shape[0]
        with torch.no_grad():
            pi_a, _ = self._sample(obs.repeat(k, 1), noise["policy"])
        sampled = torch.cat([noise["ood"], pi_a.reshape(k, b, -1)])
        cq1, cq2 = twin_q_apply(critic, obs.expand(2 * k, *obs.shape),
                                sampled)
        conservative = ((_sample_lse(cq1) - q1)
                        + (_sample_lse(cq2) - q2)).mean()
        return (td + self._cql_alpha * conservative,
                0.5 * (q1.mean() + q2.mean()), conservative)

    def _report(self, c_loss, a_loss, al_loss, mean_logp, q_mean, gap):
        alpha = self.module.log_alpha.detach().exp()
        vals = torch.stack([c_loss, a_loss, gap, q_mean, alpha])
        return dict(zip(self._METRICS, vals.tolist()))


class CQL(Algorithm):
    config_class = CQLConfig

    def setup(self, config: Dict[str, Any]):
        self.reader = read_offline(self)
        self.data = self.reader.read_all()
        self._rng = np.random.RandomState(self.algo_config.seed)
        self.build_learner()

    def build_learner(self):
        cfg = self.algo_config
        probe = make_env(cfg.env, cfg.env_config)
        self.learner = CQLLearner(
            probe.observation_dim, probe.action_dim, probe.action_low,
            probe.action_high, hidden=cfg.hidden, actor_lr=cfg.actor_lr,
            critic_lr=cfg.critic_lr, alpha_lr=cfg.alpha_lr,
            gamma=cfg.gamma, tau=cfg.tau,
            initial_alpha=cfg.initial_alpha,
            target_entropy=cfg.target_entropy, cql_alpha=cfg.cql_alpha,
            num_ood_actions=cfg.num_ood_actions, seed=cfg.seed,
            device=cfg.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        n = len(self.data)
        idx = self._rng.randint(0, n, size=min(cfg.train_batch_size, n))
        batch = SampleBatch({k: v[idx] for k, v in self.data.items()})
        m = self.learner.update(batch)
        m["num_samples_trained"] = int(len(idx))
        m["episode_reward_mean"] = float("nan")
        return m

    def save_checkpoint(self):
        return {"state": self.learner.get_weights(),
                "iteration": self._iteration}

    def load_checkpoint(self, ckpt):
        self.learner.set_weights(ckpt["state"])
        self._iteration = ckpt.get("iteration", 0)

    def cleanup(self):
        pass
