"""MARWIL: the port of ``ray_tpu/rllib/algorithms/marwil.py``
(``MARWILConfig`` :26, ``_returns_to_go`` :50, ``MARWIL`` :65).

Reference parity: rllib/algorithms/marwil/marwil.py (Wang et al. 2018):
offline imitation where each action's log-likelihood is weighted by
exp(beta * advantage), with a learned value baseline — beta=0 degrades to
plain BC. The running normalizer of squared advantages (``adv_norm``,
100.0 at first) stays on the device between updates; each update moves
it first and weights its own step with the moved value. Returns-to-go are
computed per stored fragment when the data is read
(``frag["returns"] = _returns_to_go(frag, gamma)`` over
``JsonReader.iter_batches``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.bc import (BC, BCLearner, read_offline,
                                               taken_logp)
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.models import policy_value_apply
from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_samples

RETURNS = "returns"


class MARWILConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MARWIL)
        self.input_path = ""
        self.beta = 1.0                 # advantage exponent; 0 => BC
        self.vf_coeff = 1.0
        self.moving_average_sqd_adv_norm_update_rate = 1e-2
        self.train_batch_size = 256
        self.num_env_runners = 0

    def offline_data(self, *, input_path=None) -> "MARWILConfig":
        if input_path is not None:
            self.input_path = input_path
        return self

    def training(self, *, beta=None, vf_coeff=None, **kw) -> "MARWILConfig":
        super().training(**kw)
        if beta is not None:
            self.beta = beta
        if vf_coeff is not None:
            self.vf_coeff = vf_coeff
        return self


def _returns_to_go(batch: SampleBatch, gamma: float) -> np.ndarray:
    """Discounted returns within one stored fragment; episode boundaries
    from TERMINATEDS (reference: marwil postprocesses with
    compute_advantages over complete episodes)."""
    r = np.asarray(batch[sb.REWARDS], np.float32)
    done = np.asarray(batch.get(sb.TERMINATEDS, np.zeros_like(r)),
                      np.float32)
    out = np.zeros_like(r)
    acc = 0.0
    for i in range(len(r) - 1, -1, -1):
        acc = r[i] + gamma * acc * (1.0 - done[i])
        out[i] = acc
    return out


class MARWILLearner(BCLearner):
    _COLUMNS = (sb.OBS, sb.ACTIONS, RETURNS)
    _METRICS = ("loss", "policy_loss", "vf_loss")

    def __init__(self, obs_dim: int, num_actions: int, *, hidden=(64, 64),
                 lr=5e-4, beta=1.0, vf_coeff=1.0,
                 moving_average_sqd_adv_norm_update_rate=1e-2, seed=0,
                 device=None):
        super().__init__(obs_dim, num_actions, hidden=hidden, lr=lr,
                         seed=seed, device=device)
        self._beta, self._vf_coeff = beta, vf_coeff
        self._rate = moving_average_sqd_adv_norm_update_rate
        self.adv_norm = torch.tensor(100.0, device=self.device)

    def _loss(self, c):
        """-> (loss, the moved adv_norm, policy loss, value loss)."""
        logits, values = policy_value_apply(self.module, c[sb.OBS])
        adv = c[RETURNS] - values
        new_norm = self.adv_norm + self._rate * (
            (adv ** 2).mean().detach() - self.adv_norm)
        w = torch.exp(self._beta * (adv / torch.sqrt(new_norm + 1e-8))
                      .detach()).clamp(max=20.0)   # clip exploding weights
        policy_loss = -(w * taken_logp(logits, c[sb.ACTIONS])).mean()
        vf_loss = (adv ** 2).mean()
        return (policy_loss + self._vf_coeff * vf_loss, new_norm,
                policy_loss, vf_loss)

    def update(self, batch) -> Dict[str, float]:
        loss, self.adv_norm, p_loss, v_loss = self._loss(
            self._columns(batch))
        self._step(loss)
        vals = torch.stack([loss, p_loss, v_loss]).detach()
        return dict(zip(self._METRICS, vals.tolist()))


class MARWIL(BC):
    """BC's offline loop with the advantage-weighted learner (the
    reference's BC is MARWIL with beta=0)."""

    config_class = MARWILConfig

    def setup(self, config: Dict[str, Any]):
        gamma = self.algo_config.gamma
        frags = []
        for frag in read_offline(self).iter_batches():
            frag[RETURNS] = _returns_to_go(frag, gamma)
            frags.append(frag)
        self.data = concat_samples(frags)
        self.build_learner()

    def build_learner(self):
        cfg = self.algo_config
        probe = make_env(cfg.env, cfg.env_config)
        self.learner = MARWILLearner(
            probe.observation_dim, probe.num_actions, hidden=cfg.hidden,
            lr=cfg.lr, beta=cfg.beta, vf_coeff=cfg.vf_coeff,
            moving_average_sqd_adv_norm_update_rate=(
                cfg.moving_average_sqd_adv_norm_update_rate),
            seed=cfg.seed, device=cfg.device)

    def save_checkpoint(self):
        ckpt = super().save_checkpoint()
        ckpt["adv_norm"] = self.learner.adv_norm.clone()
        return ckpt

    def load_checkpoint(self, ckpt):
        super().load_checkpoint(ckpt)
        if "adv_norm" in ckpt:
            self.learner.adv_norm = torch.as_tensor(
                ckpt["adv_norm"], dtype=torch.float32,
                device=self.learner.device)
