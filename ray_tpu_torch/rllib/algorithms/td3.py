"""TD3 and DDPG: the port of ``ray_tpu/rllib/algorithms/td3.py``
(``TD3Config`` :26, ``DDPGConfig`` :62, ``TD3Learner`` :72, ``TD3`` :193,
``DDPG`` :259).

Reference parity: rllib/algorithms/td3/td3.py (which extends
rllib/algorithms/ddpg/ddpg.py — TD3 = DDPG + twin clipped critics,
delayed policy updates, and target-policy smoothing; Fujimoto et al.
2018). DDPG is this learner with ``policy_delay=1, target_noise=0,
target_noise_clip=0`` (``DDPG_DEFAULTS``), as the reference's configs say.

JAX gates the actor step and both target syncs with a ``lax.cond`` on its
device step counter after the increment; the port counts steps on the host
and never reads the device to decide. The target-smoothing draw is
standard normal [B, action_dim] from a device ``torch.Generator`` seeded
seed+1, or passed to ``update`` as ``noise={"target": ...}``; JAX draws it
also when its scale is 0 (DDPG).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.sac import (SAC, OffPolicyLearner,
                                                StateTree, frozen_copy,
                                                polyak, transition_columns)
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.models import (det_actor_apply, det_actor_init,
                                        seeded, twin_q_apply, twin_q_init)

DDPG_DEFAULTS = dict(policy_delay=1, target_noise=0.0, target_noise_clip=0.0)


class TD3Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or TD3)
        self.env = "Pendulum-v1"
        self.tau = 0.005
        self.actor_lr = 1e-3
        self.critic_lr = 1e-3
        self.expl_noise = 0.1           # rollout Gaussian noise (of half-range)
        self.target_noise = 0.2         # target-policy smoothing sigma
        self.target_noise_clip = 0.5
        self.policy_delay = 2           # actor updated every N critic steps
        self.buffer_capacity = 100_000
        self.random_warmup_steps = 500
        self.grad_steps_per_iter = 0    # 0 => one per sampled step
        self.train_batch_size = 256
        self.rollout_fragment_length = 64

    def training(self, *, tau=None, actor_lr=None, critic_lr=None,
                 expl_noise=None, target_noise=None, target_noise_clip=None,
                 policy_delay=None, buffer_capacity=None,
                 random_warmup_steps=None, grad_steps_per_iter=None,
                 **kw) -> "TD3Config":
        super().training(**kw)
        for name, v in (("tau", tau), ("actor_lr", actor_lr),
                        ("critic_lr", critic_lr), ("expl_noise", expl_noise),
                        ("target_noise", target_noise),
                        ("target_noise_clip", target_noise_clip),
                        ("policy_delay", policy_delay),
                        ("buffer_capacity", buffer_capacity),
                        ("random_warmup_steps", random_warmup_steps),
                        ("grad_steps_per_iter", grad_steps_per_iter)):
            if v is not None:
                setattr(self, name, v)
        return self


class DDPGConfig(TD3Config):
    """DDPG = TD3 minus its three additions (reference ddpg.py defaults)."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or DDPG)
        for name, v in DDPG_DEFAULTS.items():
            setattr(self, name, v)


class TD3Learner(OffPolicyLearner):
    """TD3's update with the actor step (and both Polyak syncs) on every
    ``policy_delay``-th update."""

    _METRICS = ("critic_loss", "actor_loss", "mean_q")

    def __init__(self, obs_dim: int, action_dim: int, low: float,
                 high: float, *, hidden=(64, 64), actor_lr=1e-3,
                 critic_lr=1e-3, gamma=0.99, tau=0.005, target_noise=0.2,
                 target_noise_clip=0.5, policy_delay=2, seed=0,
                 device=None):
        device = resolve_device(device)
        gen = seeded(seed)
        actor = det_actor_init(obs_dim, action_dim, tuple(hidden),
                               generator=gen, device=device)
        critic = twin_q_init(obs_dim, action_dim, tuple(hidden),
                             generator=gen, device=device)
        module = StateTree(actor=actor, critic=critic,
                           target_actor=frozen_copy(actor),
                           target_critic=frozen_copy(critic))
        super().__init__(module, {"actor": actor_lr, "critic": critic_lr},
                         {"actor": actor.parameters(),
                          "critic": critic.parameters()}, device)
        self._action_dim = action_dim
        self._low, self._high = low, high
        self._gamma, self._tau = gamma, tau
        self._noise_scale = target_noise * (high - low) / 2.0
        self._noise_clip = target_noise_clip * (high - low) / 2.0
        self._policy_delay = policy_delay
        self._gen = seeded(seed + 1, device)
        self.steps = 0

    def draw_noise(self, n: int) -> Dict[str, torch.Tensor]:
        """JAX's draw for a batch of ``n``: the target-smoothing noise."""
        return {"target": torch.randn((n, self._action_dim),
                                      generator=self._gen,
                                      device=self.device)}

    def _critic_loss(self, c, eps):
        m = self.module
        with torch.no_grad():
            a2 = det_actor_apply(m.target_actor, c[sb.NEXT_OBS], self._low,
                                 self._high)
            # target-policy smoothing: clipped noise on the target action
            eps = (self._noise_scale * eps).clamp(-self._noise_clip,
                                                  self._noise_clip)
            a2 = (a2 + eps).clamp(self._low, self._high)
            tq1, tq2 = twin_q_apply(m.target_critic, c[sb.NEXT_OBS], a2)
            target = c[sb.REWARDS] + self._gamma * (
                1.0 - c[sb.TERMINATEDS]) * torch.minimum(tq1, tq2)
        q1, q2 = twin_q_apply(m.critic, c[sb.OBS], c[sb.ACTIONS])
        loss = ((q1 - target) ** 2 + (q2 - target) ** 2).mean()
        return loss, 0.5 * (q1.mean() + q2.mean())

    def _actor_step(self, c):
        m = self.module
        a = det_actor_apply(m.actor, c[sb.OBS], self._low, self._high)
        q1, _ = twin_q_apply(m.critic, c[sb.OBS], a)
        loss = -q1.mean()
        self._step("actor", loss)
        # Polyak sync both targets only on actor steps (TD3 paper)
        polyak(m.target_actor, m.actor, self._tau)
        polyak(m.target_critic, m.critic, self._tau)
        return loss.detach()

    def update(self, batch, noise=None) -> Dict[str, float]:
        c = transition_columns(batch, self.device)
        noise = self._noise(noise, lambda: self.draw_noise(len(batch)))
        c_loss, q_mean = self._critic_loss(c, noise["target"])
        self._step("critic", c_loss)
        self.steps += 1
        if self.steps % self._policy_delay == 0:
            a_loss = self._actor_step(c)
        else:
            a_loss = torch.zeros((), device=self.device)
        vals = torch.stack([c_loss.detach(), a_loss, q_mean.detach()])
        return dict(zip(self._METRICS, vals.tolist()))

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The state dict with JAX's ``steps`` leaf (the host counter)."""
        weights = super().get_weights()
        weights["steps"] = torch.tensor(self.steps, dtype=torch.int32)
        return weights

    def set_weights(self, weights) -> None:
        weights = dict(weights)
        if "steps" in weights:
            self.steps = int(weights.pop("steps"))
        super().set_weights(weights)


class TD3(SAC):
    """SAC's loop (uniform replay) with the deterministic runner policy
    and ``TD3Learner``."""

    config_class = TD3Config

    def _continuous_runner_kwargs(self) -> Dict[str, Any]:
        return {"policy": "deterministic",
                "expl_noise": self.algo_config.expl_noise}

    def build_learner(self):
        cfg = self.algo_config
        probe = make_env(cfg.env, cfg.env_config)
        self.learner = TD3Learner(
            probe.observation_dim, probe.action_dim, probe.action_low,
            probe.action_high, hidden=cfg.hidden, actor_lr=cfg.actor_lr,
            critic_lr=cfg.critic_lr, gamma=cfg.gamma, tau=cfg.tau,
            target_noise=cfg.target_noise,
            target_noise_clip=cfg.target_noise_clip,
            policy_delay=cfg.policy_delay, seed=cfg.seed,
            device=cfg.device)
        self.broadcast_weights(self.learner.get_actor_weights())


class DDPG(TD3):
    config_class = DDPGConfig
