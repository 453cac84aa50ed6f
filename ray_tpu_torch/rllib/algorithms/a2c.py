"""A2C: the port of ``ray_tpu/rllib/algorithms/a2c.py`` (``A2CConfig`` :18,
``A2CLearner`` :38, ``A2C`` :46).

Reference parity: rllib/algorithms/a2c/a2c.py — the PPO pipeline minus
importance ratios and clipping: vanilla policy gradient with the GAE
advantage baseline the EnvRunners already compute. Reuses the whole PPO
harness (rollout fan-out, minibatch/epoch SGD, broadcast, multi-agent,
checkpointing); only the policy-gradient term differs.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO
from ray_tpu_torch.rllib.catalog import obs_shape_of
from ray_tpu_torch.rllib.learner import PPOLearner


class A2CConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or A2C)
        self.lambda_ = 1.0           # reference A2C default (full GAE off)
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_epochs = 1          # on-policy default: one fresh pass

    def training(self, *, lambda_=None, vf_loss_coeff=None,
                 entropy_coeff=None, **kw) -> "A2CConfig":
        super().training(**kw)
        if lambda_ is not None:
            self.lambda_ = lambda_
        if vf_loss_coeff is not None:
            self.vf_loss_coeff = vf_loss_coeff
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        return self


class A2CLearner(PPOLearner):
    """PPOLearner with the vanilla advantage policy gradient (no
    importance ratio / clipping); minibatch/epoch handling inherited."""

    def _pg_loss(self, logp, old_logp, adv):
        return -(logp * adv).mean()


class A2C(PPO):
    """Shares PPO's rollout fan-out/broadcast harness; swaps the learner."""

    config_class = A2CConfig

    def _make_learner(self, probe, seed_offset: int = 0):
        cfg = self.algo_config
        return A2CLearner(
            probe.observation_dim, probe.num_actions, hidden=cfg.hidden,
            lr=cfg.lr, vf_coeff=cfg.vf_loss_coeff,
            entropy_coeff=cfg.entropy_coeff, seed=cfg.seed + seed_offset,
            obs_shape=obs_shape_of(probe),
            model=None if cfg.is_multi_agent else cfg.model,
            seq_len=cfg.rollout_fragment_length, device=cfg.device)
