"""SAC's compute: the port of ``ray_tpu/rllib/algorithms/sac.py``
(``SACLearner`` :72).

Reference parity: rllib/algorithms/sac/sac.py (+ sac_torch_policy losses):
tanh-squashed Gaussian actor, clipped double-Q critics with Polyak-averaged
targets, and automatic entropy-temperature tuning (target entropy
-action_dim). The algorithm's loop (``SAC.training_step``: sample with
``ContinuousEnvRunner``s -> replay buffer -> one update per sampled step ->
actor weights to the runners) is orchestration and is not ported.

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
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.learner import ADAM_EPS, to_tensor
from ray_tpu_torch.rllib.models import (seeded, squashed_gaussian_init,
                                        squashed_gaussian_sample,
                                        twin_q_apply, twin_q_init)


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
