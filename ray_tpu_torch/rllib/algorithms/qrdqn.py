"""QR-DQN: the port of ``ray_tpu/rllib/algorithms/qrdqn.py``
(``QRDQNConfig`` :24, ``QRDQNRunner`` :47, ``QRDQNLearner`` :71,
``QRDQN`` :154).

Reference parity: Dabney et al. 2018 through the reference's DQN
num_atoms/distributional family: the net emits N quantile estimates of the
return per action and trains with the quantile Huber loss over the
pairwise [B, N, N] TD errors.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithms.dqn import (DQN, NSTEP_GAMMAS,
                                                DQNConfig, QLearner,
                                                _greedy)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.models import mlp_apply, policy_value_init, seeded


class QRDQNConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or QRDQN)
        self.n_quantiles = 32
        self.kappa = 1.0          # Huber threshold

    def training(self, *, n_quantiles=None, kappa=None,
                 **kw) -> "QRDQNConfig":
        super().training(**kw)
        if n_quantiles is not None:
            self.n_quantiles = n_quantiles
        if kappa is not None:
            self.kappa = kappa
        return self


def _quantile_init(seed, obs_dim, num_actions, n_quantiles, hidden, device):
    return policy_value_init(obs_dim, num_actions * n_quantiles,
                             tuple(hidden), generator=seeded(seed),
                             device=device)


def _thetas(p, obs, num_actions, n_quantiles):
    return mlp_apply(p["pi"], obs).reshape(obs.shape[0], num_actions,
                                           n_quantiles)


class QRDQNRunner(EnvRunner):
    """Greedy scores = mean over the quantile estimates per action."""

    def __init__(self, *args, n_quantiles=32, **kw):
        self._n_quantiles = n_quantiles
        super().__init__(*args, **kw)

    def _build_policy(self, seed, hidden, model):
        e0 = self._envs[0]
        n_act, n_q = e0.num_actions, self._n_quantiles
        self.module = _quantile_init(seed, e0.observation_dim, n_act, n_q,
                                     hidden, self.device)
        self._forward = _greedy(
            lambda p, obs: _thetas(p, obs, n_act, n_q).mean(-1))


class QRDQNLearner(QLearner):
    def __init__(self, obs_dim: int, num_actions: int, *, hidden=(64, 64),
                 lr=5e-4, gamma=0.99, n_quantiles=32, kappa=1.0,
                 double_q=True, seed=0, device=None):
        device = resolve_device(device)
        self._num_actions, self._n_quantiles = num_actions, n_quantiles
        self._kappa = kappa
        self._double_q = double_q
        # Quantile midpoints tau_hat_i = (2i+1)/(2N).
        self._tau = ((2 * torch.arange(n_quantiles, device=device) + 1)
                     / (2.0 * n_quantiles))
        super().__init__(_quantile_init(seed, obs_dim, num_actions,
                                        n_quantiles, hidden, device),
                         lr, gamma, device)

    def _thetas(self, p, obs):
        return _thetas(p, obs, self._num_actions, self._n_quantiles)

    def _loss(self, c):
        kappa = self._kappa
        rows = torch.arange(len(c[sb.ACTIONS]), device=self.device)
        th = self._thetas(self.module, c[sb.OBS])[rows, c[sb.ACTIONS]]
        with torch.no_grad():
            next_t = self._thetas(self.target, c[sb.NEXT_OBS])
            sel = (self._thetas(self.module, c[sb.NEXT_OBS])
                   if self._double_q else next_t)
            next_q = next_t[rows, sel.mean(-1).argmax(-1)]     # [B, N]
            not_done = (1.0 - c[sb.TERMINATEDS].float())[:, None]
            target = (c[sb.REWARDS][:, None]
                      + c[NSTEP_GAMMAS][:, None] * not_done * next_q)
        # Pairwise TD errors u_ij = target_j - theta_i -> [B, N, N].
        u = target[:, None, :] - th[:, :, None]
        huber = torch.where(u.abs() <= kappa, 0.5 * u * u,
                            kappa * (u.abs() - 0.5 * kappa))
        # Quantile weighting |tau_i - 1{u<0}| applied per theta row.
        w = (self._tau[None, :, None] - (u < 0).float()).abs()
        per_sample = (w * huber).mean(-1).sum(-1)              # [B]
        return (c["weights"] * per_sample).mean(), per_sample


class QRDQN(DQN):
    config_class = QRDQNConfig
    supports_model_config = False  # custom head, not catalog-built

    def _runner_class(self):
        return QRDQNRunner

    def _extra_runner_kwargs(self) -> Dict[str, Any]:
        return {"n_quantiles": self.algo_config.n_quantiles}

    def _make_q_learner(self, probe):
        cfg = self.algo_config
        return QRDQNLearner(
            probe.observation_dim, probe.num_actions, hidden=cfg.hidden,
            lr=cfg.lr, gamma=cfg.gamma, n_quantiles=cfg.n_quantiles,
            kappa=cfg.kappa, double_q=cfg.double_q, seed=cfg.seed,
            device=cfg.device)
