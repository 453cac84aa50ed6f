"""PG: the port of ``ray_tpu/rllib/algorithms/pg.py`` (``PGConfig`` :24,
``PGLearner`` :43, ``PG`` :50).

Reference parity: rllib/algorithms/pg — vanilla REINFORCE: the gradient
weights each action's log-prob by the empirical discounted return (no
importance ratio, no clipping, no advantage baseline). Shares the PPO
rollout harness; the runners' GAE runs with lambda=1 so VALUE_TARGETS is
exactly the Monte-Carlo return (bootstrapped by V only where a fragment
truncates mid-episode — the value head is trained for that tail bootstrap
but is NOT used as a baseline).
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.a2c import A2CLearner
from ray_tpu_torch.rllib.algorithms.ppo import PPO
from ray_tpu_torch.rllib.catalog import obs_shape_of
from ray_tpu_torch.rllib.sample_batch import concat_samples


class PGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PG)
        self.lambda_ = 1.0          # Monte-Carlo returns
        self.vf_loss_coeff = 0.5    # V trains only for truncation bootstrap
        self.entropy_coeff = 0.0
        self.num_epochs = 1         # one pass: the gradient is on-policy

    def training(self, *, vf_loss_coeff=None, entropy_coeff=None,
                 **kw) -> "PGConfig":
        super().training(**kw)
        if vf_loss_coeff is not None:
            self.vf_loss_coeff = vf_loss_coeff
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        return self


class PGLearner(A2CLearner):
    """A2C's vanilla -logp*adv gradient; PG feeds it returns instead of
    advantages (the whitening in the shared loss is a constant baseline,
    which keeps the REINFORCE gradient unbiased)."""


class PG(PPO):
    config_class = PGConfig

    def _make_learner(self, probe, seed_offset: int = 0):
        cfg = self.algo_config
        return PGLearner(
            probe.observation_dim, probe.num_actions, hidden=cfg.hidden,
            lr=cfg.lr, vf_coeff=cfg.vf_loss_coeff,
            entropy_coeff=cfg.entropy_coeff, seed=cfg.seed + seed_offset,
            obs_shape=obs_shape_of(probe),
            model=None if cfg.is_multi_agent else cfg.model,
            seq_len=cfg.rollout_fragment_length, device=cfg.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        if cfg.is_multi_agent:
            raise NotImplementedError(
                "PG is single-policy; use A2C/PPO for multi-agent")
        batch = concat_samples(self._rt.get(self.sample_all_runners()))
        # REINFORCE: weight log-probs by the return, not the GAE advantage.
        batch[sb.ADVANTAGES] = batch[sb.VALUE_TARGETS]
        metrics = self.learner.update(
            batch, minibatch_size=min(cfg.minibatch_size, len(batch)),
            num_epochs=cfg.num_epochs, seed=cfg.seed + self._iteration)
        self.broadcast_weights(self.learner.get_weights())
        metrics["num_env_steps_sampled"] = len(batch)
        return metrics
