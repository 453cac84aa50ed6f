"""NoisyNet-DQN: the port of ``ray_tpu/rllib/algorithms/noisy.py``
(``NoisyDQNConfig`` :26, ``noisy_net_init`` :41, ``noisy_net_apply`` :63,
``NoisyDQNRunner`` :87, ``NoisyDQNLearner`` :113, ``NoisyDQN`` :192).

Reference parity: Fortunato et al. 2018 factorized Gaussian noisy linear
layers (the reference DQN's ``noisy: True``): every weight is
mu + sigma * (f(eps_in) f(eps_out)^T) with f(x) = sign(x)sqrt(|x|);
exploration comes from the learned sigmas, and epsilon is zero.

The noise is drawn apart from the forward: ``noisy_net_noise`` draws one
(f(eps_in), f(eps_out)) pair per layer from a ``torch.Generator`` (seeded
seed+77 in the runner and seed+13 in the learner, as JAX seeds its keys),
and ``noisy_net_apply`` takes it, so a caller can pass in noise drawn
elsewhere (JAX's, in the parity tests).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithms.dqn import (DQN, NSTEP_GAMMAS,
                                                DQNConfig, QLearner,
                                                _greedy, taken)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.models import Leaves, seeded


class NoisyDQNConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or NoisyDQN)
        self.sigma0 = 0.5          # initial sigma scale (paper default)
        # Exploration is the noise itself.
        self.epsilon_start = 0.0
        self.epsilon_end = 0.0

    def training(self, *, sigma0=None, **kw) -> "NoisyDQNConfig":
        super().training(**kw)
        if sigma0 is not None:
            self.sigma0 = sigma0
        return self


def noisy_net_init(seed: int, sizes, sigma0: float = 0.5,
                   device=None) -> nn.ModuleDict:
    """``{"q": [layer, ...]}`` of factorized-noise linear layers: each layer
    holds (mu_w, mu_b, sig_w, sig_b); mu ~ U(-1/sqrt(fan_in), +), sigma =
    sigma0/sqrt(fan_in)."""
    gen = seeded(seed)
    layers = nn.ModuleList()
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        bound = 1.0 / math.sqrt(fi)
        layers.append(Leaves(
            mu_w=(torch.rand(fi, fo, generator=gen) * 2 - 1) * bound,
            mu_b=(torch.rand(fo, generator=gen) * 2 - 1) * bound,
            sig_w=torch.full((fi, fo), sigma0 / math.sqrt(fi)),
            sig_b=torch.full((fo,), sigma0 / math.sqrt(fi))))
    return nn.ModuleDict({"q": layers}).to(resolve_device(device))


def noisy_net_noise(layers, generator: torch.Generator):
    """One factorized draw per layer: [(f(eps_in) [fan_in], f(eps_out)
    [fan_out]), ...] on the generator's device."""
    def f(e):
        return torch.sign(e) * e.abs().sqrt()

    dev = generator.device
    return [(f(torch.randn(layer.mu_w.shape[0], generator=generator,
                           device=dev)),
             f(torch.randn(layer.mu_w.shape[1], generator=generator,
                           device=dev)))
            for layer in layers]


def noisy_net_apply(layers, x, noise):
    """Forward with the given factorized noise; noise=None gives the
    deterministic mu-only net (evaluation mode)."""
    for i, layer in enumerate(layers):
        if noise is None:
            w, b = layer.mu_w, layer.mu_b
        else:
            e_in, e_out = noise[i]
            w = layer.mu_w + layer.sig_w * torch.outer(e_in, e_out)
            b = layer.mu_b + layer.sig_b * e_out
        x = x @ w + b
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


class NoisyDQNRunner(EnvRunner):
    """Greedy over the noisy Q values — a fresh noise draw per forward is
    the exploration policy (no epsilon)."""

    def __init__(self, *args, sigma0=0.5, **kw):
        self._sigma0 = sigma0
        super().__init__(*args, **kw)

    def _build_policy(self, seed, hidden, model):
        e0 = self._envs[0]
        self.module = noisy_net_init(
            seed, [e0.observation_dim, *hidden, e0.num_actions],
            self._sigma0, self.device)
        self._noise = seeded(seed + 77, self.device)
        self._forward = _greedy(lambda p, obs: noisy_net_apply(
            p["q"], obs, noisy_net_noise(p["q"], self._noise)))


class NoisyDQNLearner(QLearner):
    def __init__(self, obs_dim: int, num_actions: int, *, hidden=(64, 64),
                 lr=5e-4, gamma=0.99, double_q=True, sigma0=0.5, seed=0,
                 device=None):
        device = resolve_device(device)
        self._double_q = double_q
        self._noise = seeded(seed + 13, device)
        super().__init__(noisy_net_init(seed, [obs_dim, *hidden,
                                               num_actions], sigma0, device),
                         lr, gamma, device)

    def update(self, batch, noise=None):
        """One TD step. ``noise``: three draws of ``noisy_net_noise`` (the
        online, target and double-Q selection nets', drawn independently
        as in the paper's TD estimate); drawn from the learner's generator
        when not given."""
        if noise is None:
            noise = [noisy_net_noise(self.module["q"], self._noise)
                     for _ in range(3)]
        return super().update(batch, noise=noise)

    def _loss(self, c, noise):
        q_taken = taken(noisy_net_apply(self.module["q"], c[sb.OBS],
                                        noise[0]), c[sb.ACTIONS])
        with torch.no_grad():
            q_next_t = noisy_net_apply(self.target["q"], c[sb.NEXT_OBS],
                                       noise[1])
            if self._double_q:
                a_next = noisy_net_apply(self.module["q"], c[sb.NEXT_OBS],
                                         noise[2]).argmax(-1)
                v_next = taken(q_next_t, a_next)
            else:
                v_next = q_next_t.max(-1).values
            not_done = 1.0 - c[sb.TERMINATEDS].float()
            target = c[sb.REWARDS] + c[NSTEP_GAMMAS] * not_done * v_next
        td = q_taken - target
        return (c["weights"] * td * td).mean(), td.abs()


class NoisyDQN(DQN):
    config_class = NoisyDQNConfig
    supports_model_config = False  # custom head, not catalog-built

    def _runner_class(self):
        return NoisyDQNRunner

    def _extra_runner_kwargs(self) -> Dict[str, Any]:
        return {"sigma0": self.algo_config.sigma0}

    def _make_q_learner(self, probe):
        cfg = self.algo_config
        return NoisyDQNLearner(
            probe.observation_dim, probe.num_actions, hidden=cfg.hidden,
            lr=cfg.lr, gamma=cfg.gamma, double_q=cfg.double_q,
            sigma0=cfg.sigma0, seed=cfg.seed, device=cfg.device)
