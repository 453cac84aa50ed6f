"""C51: the port of ``ray_tpu/rllib/algorithms/c51.py`` (``C51Config`` :25,
``C51Runner`` :48, ``C51Learner`` :78, ``C51`` :174).

Reference parity: rllib/algorithms/dqn with num_atoms>1. The Q network
emits a categorical distribution over `n_atoms` fixed support atoms per
action; the TD update projects the Bellman-shifted target distribution
back onto the support and minimizes cross-entropy (Bellemare et al. 2017),
vectorized with two ``scatter_add_``s (JAX's ``.at[].add``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithms.dqn import (DQN, NSTEP_GAMMAS,
                                                DQNConfig, QLearner,
                                                _greedy)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.models import mlp_apply, policy_value_init, seeded


class C51Config(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or C51)
        self.n_atoms = 51
        self.v_min = -10.0
        self.v_max = 10.0

    def training(self, *, n_atoms=None, v_min=None, v_max=None,
                 **kw) -> "C51Config":
        super().training(**kw)
        for name, val in (("n_atoms", n_atoms), ("v_min", v_min),
                          ("v_max", v_max)):
            if val is not None:
                setattr(self, name, val)
        return self


def _dist_init(seed, obs_dim, num_actions, n_atoms, hidden, device):
    return policy_value_init(obs_dim, num_actions * n_atoms, tuple(hidden),
                             generator=seeded(seed), device=device)


def _dist_logits(p, obs, num_actions, n_atoms):
    return mlp_apply(p["pi"], obs).reshape(obs.shape[0], num_actions,
                                           n_atoms)


class C51Runner(EnvRunner):
    """EnvRunner whose greedy scores are EXPECTED Q values under the
    categorical head (argmax over raw A*N logits would be meaningless)."""

    def __init__(self, *args, n_atoms=51, v_min=-10.0, v_max=10.0, **kw):
        # Set before super().__init__: the base ctor calls _build_policy.
        self._n_atoms = n_atoms
        self._v_min, self._v_max = v_min, v_max
        super().__init__(*args, **kw)

    def _build_policy(self, seed, hidden, model):
        e0 = self._envs[0]
        n_act, n_atoms = e0.num_actions, self._n_atoms
        z = torch.linspace(self._v_min, self._v_max, n_atoms,
                           device=self.device)
        self.module = _dist_init(seed, e0.observation_dim, n_act, n_atoms,
                                 hidden, self.device)
        self._forward = _greedy(lambda p, obs: (torch.softmax(
            _dist_logits(p, obs, n_act, n_atoms), -1) * z).sum(-1))


class C51Learner(QLearner):
    def __init__(self, obs_dim: int, num_actions: int, *, hidden=(64, 64),
                 lr=5e-4, gamma=0.99, n_atoms=51, v_min=-10.0, v_max=10.0,
                 double_q=True, seed=0, device=None):
        device = resolve_device(device)
        self._num_actions, self._n_atoms = num_actions, n_atoms
        self._v_min, self._v_max = v_min, v_max
        self._double_q = double_q
        self._z = torch.linspace(v_min, v_max, n_atoms, device=device)
        super().__init__(_dist_init(seed, obs_dim, num_actions, n_atoms,
                                    hidden, device), lr, gamma, device)

    def _logits(self, p, obs):
        return _dist_logits(p, obs, self._num_actions, self._n_atoms)

    def _loss(self, c):
        v_min, v_max, z = self._v_min, self._v_max, self._z
        rows = torch.arange(len(c[sb.ACTIONS]), device=self.device)
        logp_taken = F.log_softmax(
            self._logits(self.module, c[sb.OBS])[rows, c[sb.ACTIONS]],
            -1)                                                # [B, N]
        with torch.no_grad():
            # Greedy next action by expected value (double-Q: online net
            # selects, target net evaluates the distribution).
            next_t = self._logits(self.target, c[sb.NEXT_OBS])
            next_sel = (self._logits(self.module, c[sb.NEXT_OBS])
                        if self._double_q else next_t)
            a_next = (torch.softmax(next_sel, -1) * z).sum(-1).argmax(-1)
            p_next = torch.softmax(next_t[rows, a_next], -1)   # [B, N]
            # Bellman-shift the support and project onto the fixed atoms.
            not_done = (1.0 - c[sb.TERMINATEDS].float())[:, None]
            tz = (c[sb.REWARDS][:, None]
                  + c[NSTEP_GAMMAS][:, None] * not_done * z[None, :]
                  ).clamp(v_min, v_max)
            b = (tz - v_min) / ((v_max - v_min) / (self._n_atoms - 1))
            low, high = b.floor().long(), b.ceil().long()
            # When b lands exactly on an atom (low == high) all mass goes
            # to that atom via the `low` scatter.
            w_low = torch.where(low == high, 1.0, high - b)
            proj = torch.zeros_like(p_next)
            proj.scatter_add_(1, low, p_next * w_low)
            proj.scatter_add_(1, high, p_next * (b - low))
        ce = -(proj * logp_taken).sum(-1)                      # [B]
        # Cross-entropy doubles as the PER priority (the reference uses
        # the same signal for distributional Q).
        return (c["weights"] * ce).mean(), ce



class C51(DQN):
    config_class = C51Config
    supports_model_config = False  # custom head, not catalog-built

    def _runner_class(self):
        return C51Runner

    def _extra_runner_kwargs(self) -> Dict[str, Any]:
        cfg = self.algo_config
        return {"n_atoms": cfg.n_atoms, "v_min": cfg.v_min,
                "v_max": cfg.v_max}

    def _make_q_learner(self, probe):
        cfg = self.algo_config
        return C51Learner(
            probe.observation_dim, probe.num_actions, hidden=cfg.hidden,
            lr=cfg.lr, gamma=cfg.gamma, n_atoms=cfg.n_atoms,
            v_min=cfg.v_min, v_max=cfg.v_max, double_q=cfg.double_q,
            seed=cfg.seed, device=cfg.device)
