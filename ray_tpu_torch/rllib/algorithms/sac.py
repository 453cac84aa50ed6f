"""SAC: the port of ``ray_tpu/rllib/algorithms/sac.py`` (``SACConfig`` :25,
``SACLearner`` :72, ``SAC`` :201).

Reference parity: rllib/algorithms/sac/sac.py (+ sac_torch_policy losses):
tanh-squashed Gaussian actor, clipped double-Q critics with Polyak-averaged
targets, and automatic entropy-temperature tuning (target entropy
-action_dim). The algorithm's loop (``SAC.training_step``): sample with
``ContinuousEnvRunner``s -> replay buffer -> one update per sampled step ->
actor weights to the runners.

JAX differentiates each loss with respect to one part of its state tree.
Here each step takes ``torch.autograd.grad`` of its loss with respect to
its own parameters and steps its own ``torch.optim.Adam`` (optax's
``adam``), so the actor's loss, which runs through the critic and
``exp(log_alpha)``, leaves no gradient in either. The order is JAX's:
the critic step, the actor's loss on the updated critic with the old
``log_alpha``, alpha from the actor's mean log-prob, then Polyak.

The standard-normal draws come from a device ``torch.Generator`` seeded
seed+1 (JAX's ``_key``), or are passed to ``update`` as ``noise``: a dict
of the draws, shaped as JAX draws them (``draw_noise``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import get_env_creator, make_env
from ray_tpu_torch.rllib.env_runner import ContinuousEnvRunner
from ray_tpu_torch.rllib.learner import ADAM_EPS, to_tensor
from ray_tpu_torch.rllib.models import (seeded, squashed_gaussian_init,
                                        squashed_gaussian_sample,
                                        twin_q_apply, twin_q_init)
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)
from ray_tpu_torch.rllib.sample_batch import concat_samples


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SAC)
        self.env = "Pendulum-v1"
        self.tau = 0.005
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.initial_alpha = 1.0
        self.target_entropy = None          # None => -action_dim
        self.buffer_capacity = 100_000
        self.random_warmup_steps = 500
        self.grad_steps_per_iter = 0        # 0 => one per sampled step
        self.train_batch_size = 256
        self.rollout_fragment_length = 64
        # Prioritized experience replay (reference: sac.py
        # replay_buffer_config prioritized_replay*): proportional
        # priorities from |TD error|, importance weights into the
        # critic loss.
        self.prioritized_replay = False
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4

    def training(self, *, tau=None, actor_lr=None, critic_lr=None,
                 alpha_lr=None, initial_alpha=None, target_entropy=None,
                 buffer_capacity=None, random_warmup_steps=None,
                 grad_steps_per_iter=None, prioritized_replay=None,
                 prioritized_replay_alpha=None,
                 prioritized_replay_beta=None, **kw) -> "SACConfig":
        super().training(**kw)
        for name, v in (("tau", tau), ("actor_lr", actor_lr),
                        ("critic_lr", critic_lr), ("alpha_lr", alpha_lr),
                        ("initial_alpha", initial_alpha),
                        ("target_entropy", target_entropy),
                        ("buffer_capacity", buffer_capacity),
                        ("random_warmup_steps", random_warmup_steps),
                        ("grad_steps_per_iter", grad_steps_per_iter),
                        ("prioritized_replay", prioritized_replay),
                        ("prioritized_replay_alpha",
                         prioritized_replay_alpha),
                        ("prioritized_replay_beta",
                         prioritized_replay_beta)):
            if v is not None:
                setattr(self, name, v)
        return self


class StateTree(nn.Module):
    """A JAX learner's ``state`` dict as one module: networks as submodules
    and scalar leaves as parameters, so ``state_dict`` names are the tree's
    paths (``actor.net.0.w``, ``log_alpha``) and ``rllib/convert.py`` moves
    the JAX state in whole."""

    def __init__(self, **parts):
        super().__init__()
        for name, part in parts.items():
            setattr(self, name, part if isinstance(part, nn.Module)
                    else nn.Parameter(part))


def frozen_copy(module: nn.Module) -> nn.Module:
    """A target network: a copy that takes no gradient."""
    return copy.deepcopy(module).requires_grad_(False)


@torch.no_grad()
def polyak(target: nn.Module, source: nn.Module, tau: float) -> None:
    """target <- (1 - tau) target + tau source, leaf by leaf."""
    t, s = list(target.parameters()), list(source.parameters())
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, s, alpha=tau)


def transition_columns(batch, device, weights: bool = False):
    """A replayed batch's columns on ``device`` as JAX's ``update`` casts
    them: float32, actions [B, action_dim], terminateds as 0/1; with
    ``weights``, PER's importance weights (ones when absent)."""
    n = len(batch)
    c = {k: to_tensor(batch[k], device)
         for k in (sb.OBS, sb.REWARDS, sb.NEXT_OBS)}
    c[sb.ACTIONS] = to_tensor(
        np.asarray(batch[sb.ACTIONS], np.float32).reshape(n, -1), device)
    c[sb.TERMINATEDS] = to_tensor(
        np.asarray(batch[sb.TERMINATEDS], np.float32), device)
    if weights:
        c["weights"] = (to_tensor(batch["weights"], device)
                        if "weights" in batch else
                        torch.ones(n, device=device))
    return c


class OffPolicyLearner:
    """The parts of the SAC family's learners: ``module`` (a ``StateTree``),
    one Adam per part (``optimizers``), and the weights' hand-off as state
    dicts (snapshots, as JAX's arrays are immutable)."""

    def __init__(self, module: StateTree, lrs: Dict[str, float], parts,
                 device: torch.device):
        self.device = device
        self.module = module
        self._params = {name: list(ps) for name, ps in parts.items()}
        self.optimizers = {
            name: torch.optim.Adam(self._params[name], lr=lrs[name],
                                   eps=ADAM_EPS)
            for name in self._params}

    def _step(self, part: str, loss: torch.Tensor) -> None:
        """One Adam step of ``part`` on the gradient of ``loss`` with respect
        to ``part``'s parameters alone."""
        params = self._params[part]
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        self.optimizers[part].step()

    def _noise(self, noise, draw):
        """The injected draws on the device, or fresh ones from ``draw``."""
        if noise is None:
            return draw()
        return {k: torch.as_tensor(
            v if torch.is_tensor(v) else np.array(v, np.float32),
            dtype=torch.float32, device=self.device)
            for k, v in noise.items()}

    def get_actor_weights(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone()
                for k, v in self.module.actor.state_dict().items()}

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone()
                for k, v in self.module.state_dict().items()}

    def set_weights(self, weights) -> None:
        self.module.load_state_dict(weights)


class SACLearner(OffPolicyLearner):
    """One SAC update: critic TD, actor reparameterized, alpha, Polyak."""

    _METRICS = ("critic_loss", "actor_loss", "alpha_loss", "alpha",
                "mean_q", "entropy")

    def __init__(self, obs_dim: int, action_dim: int, low: float,
                 high: float, *, hidden=(64, 64), actor_lr=3e-4,
                 critic_lr=3e-4, alpha_lr=3e-4, gamma=0.99, tau=0.005,
                 initial_alpha=1.0, target_entropy=None, seed=0,
                 device=None):
        device = resolve_device(device)
        if target_entropy is None:
            target_entropy = -float(action_dim)
        gen = seeded(seed)
        actor = squashed_gaussian_init(obs_dim, action_dim, tuple(hidden),
                                       generator=gen, device=device)
        critic = twin_q_init(obs_dim, action_dim, tuple(hidden),
                             generator=gen, device=device)
        log_alpha = torch.log(torch.tensor(float(initial_alpha),
                                           device=device))
        module = StateTree(actor=actor, critic=critic, log_alpha=log_alpha,
                           target_critic=frozen_copy(critic))
        super().__init__(
            module, {"actor": actor_lr, "critic": critic_lr,
                     "alpha": alpha_lr},
            {"actor": actor.parameters(), "critic": critic.parameters(),
             "alpha": [module.log_alpha]}, device)
        self._action_dim = action_dim
        self._low, self._high = low, high
        self._gamma, self._tau = gamma, tau
        self._target_entropy = target_entropy
        self._gen = seeded(seed + 1, device)
        self.last_td_error: Optional[np.ndarray] = None

    def _randn(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen, device=self.device)

    def draw_noise(self, n: int) -> Dict[str, torch.Tensor]:
        """JAX's draws for a batch of ``n``: the critic target's action
        sample and the actor loss's, each [n, action_dim]."""
        a = self._action_dim
        return {"critic": self._randn(n, a), "actor": self._randn(n, a)}

    def _sample(self, obs, eps):
        return squashed_gaussian_sample(None, self.module.actor, obs,
                                        self._low, self._high, eps=eps)

    def _td_target(self, c, eps):
        m = self.module
        with torch.no_grad():
            a2, logp2 = self._sample(c[sb.NEXT_OBS], eps)
            tq1, tq2 = twin_q_apply(m.target_critic, c[sb.NEXT_OBS], a2)
            return c[sb.REWARDS] + self._gamma * (
                1.0 - c[sb.TERMINATEDS]) * (
                    torch.minimum(tq1, tq2) - m.log_alpha.exp() * logp2)

    def _critic_loss(self, c, noise):
        """-> (loss, mean Q, |TD| per sample)."""
        target = self._td_target(c, noise["critic"])
        q1, q2 = twin_q_apply(self.module.critic, c[sb.OBS], c[sb.ACTIONS])
        loss = (c["weights"] * ((q1 - target) ** 2
                                + (q2 - target) ** 2)).mean()
        return loss, 0.5 * (q1.mean() + q2.mean()), (q1 - target).abs()

    def _actor_step(self, c, eps, critic):
        """The actor's Adam step on its loss through ``critic`` (the updated
        one) at the current alpha. -> (loss, mean log-prob)."""
        a, logp = self._sample(c[sb.OBS], eps)
        q1, q2 = twin_q_apply(critic, c[sb.OBS], a)
        alpha = self.module.log_alpha.detach().exp()
        loss = (alpha * logp - torch.minimum(q1, q2)).mean()
        self._step("actor", loss)
        return loss.detach(), logp.mean().detach()

    def _alpha_step(self, mean_logp):
        loss = -(self.module.log_alpha
                 * (mean_logp + self._target_entropy))
        self._step("alpha", loss)
        return loss.detach()

    def _columns(self, batch):
        return transition_columns(batch, self.device, weights=True)

    def update(self, batch, noise=None) -> Dict[str, float]:
        """One update on a replayed batch (``weights``: PER's importance
        weights, ones when absent); ``last_td_error`` is |q1 - target|."""
        c = self._columns(batch)
        noise = self._noise(noise, lambda: self.draw_noise(len(batch)))
        c_loss, q_mean, extra = self._critic_loss(c, noise)
        self._step("critic", c_loss)
        a_loss, mean_logp = self._actor_step(c, noise["actor"],
                                             self.module.critic)
        al_loss = self._alpha_step(mean_logp)
        polyak(self.module.target_critic, self.module.critic, self._tau)
        return self._report(c_loss.detach(), a_loss, al_loss, mean_logp,
                            q_mean.detach(), extra.detach())

    def _report(self, c_loss, a_loss, al_loss, mean_logp, q_mean, td):
        """The metrics and the |TD| column in one read from the device."""
        alpha = self.module.log_alpha.detach().exp()
        vals = torch.cat([torch.stack([c_loss, a_loss, al_loss, alpha,
                                       q_mean, -mean_logp]), td]).cpu()
        k = len(self._METRICS)
        self.last_td_error = vals[k:].numpy()
        return dict(zip(self._METRICS, vals[:k].tolist()))


class SAC(Algorithm):
    """Continuous control over ``ContinuousEnvRunner``s; TD3 and DDPG
    share this loop with their own runner policy and learner."""

    config_class = SACConfig

    def _continuous_runner_kwargs(self) -> Dict[str, Any]:
        return {}

    def setup(self, config: Dict[str, Any]):
        cfg = self.algo_config
        creator = get_env_creator(cfg.env)
        runner_cls = self._rt.remote(num_cpus=1)(ContinuousEnvRunner)
        self.env_runners = [
            runner_cls.remote(creator, cfg.env_config,
                              cfg.num_envs_per_env_runner,
                              seed=cfg.seed + 1000 * i, hidden=cfg.hidden,
                              obs_connectors=cfg.obs_connectors,
                              action_connectors=cfg.action_connectors,
                              device=cfg.device,
                              **self._continuous_runner_kwargs())
            for i in range(cfg.num_env_runners)
        ]
        self._episode_rewards = []
        self._steps_sampled = 0
        if getattr(cfg, "prioritized_replay", False):
            self.buffer = PrioritizedReplayBuffer(
                cfg.buffer_capacity, alpha=cfg.prioritized_replay_alpha,
                seed=cfg.seed)
        else:
            self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        self.build_learner()

    def build_learner(self):
        cfg = self.algo_config
        probe = make_env(cfg.env, cfg.env_config)
        self.learner = SACLearner(
            probe.observation_dim, probe.action_dim, probe.action_low,
            probe.action_high, hidden=cfg.hidden, actor_lr=cfg.actor_lr,
            critic_lr=cfg.critic_lr, alpha_lr=cfg.alpha_lr,
            gamma=cfg.gamma, tau=cfg.tau,
            initial_alpha=cfg.initial_alpha,
            target_entropy=cfg.target_entropy, seed=cfg.seed,
            device=cfg.device)
        self.broadcast_weights(self.learner.get_actor_weights())

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        refs = [er.sample_transitions.remote(
            cfg.rollout_fragment_length, cfg.random_warmup_steps,
            self._steps_sampled) for er in self.env_runners]
        batch = concat_samples(self._rt.get(refs))
        self.buffer.add(batch)
        self._steps_sampled += len(batch)
        grad_steps = cfg.grad_steps_per_iter or len(batch)
        metrics: Dict[str, Any] = {}
        if len(self.buffer) >= cfg.train_batch_size:
            per = getattr(cfg, "prioritized_replay", False)
            for _ in range(grad_steps):
                if per:
                    sample = self.buffer.sample(
                        cfg.train_batch_size,
                        beta=cfg.prioritized_replay_beta)
                else:
                    sample = self.buffer.sample(cfg.train_batch_size)
                m = self.learner.update(sample)
                if per:
                    self.buffer.update_priorities(
                        sample["batch_indexes"],
                        self.learner.last_td_error + 1e-6)
            metrics.update(m)
        self.broadcast_weights(self.learner.get_actor_weights())
        metrics["num_env_steps_sampled"] = self._steps_sampled
        metrics["buffer_size"] = len(self.buffer)
        return metrics

    def save_checkpoint(self):
        return {"state": self.learner.get_weights(),
                "iteration": self._iteration}

    def load_checkpoint(self, ckpt):
        self.learner.set_weights(ckpt["state"])
        self._iteration = ckpt.get("iteration", 0)
        self.broadcast_weights(self.learner.get_actor_weights())
