"""APPO: the port of ``ray_tpu/rllib/algorithms/appo.py`` (``APPOConfig``
:18, ``APPO`` :31).

Reference parity: rllib/algorithms/appo/appo.py — IMPALA's pipelined
architecture (consume whichever rollout lands first, re-dispatch the
runner immediately) with the PPO surrogate objective and multiple SGD
epochs per batch plus a periodically-refreshed behavior anchor (the
reference's target network) to bound off-policy drift.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithms.impala import Impala, ImpalaConfig


class APPOConfig(ImpalaConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APPO)
        self.num_epochs = 2            # unlike IMPALA's single pass
        self.target_update_frequency = 4

    def training(self, *, target_update_frequency=None, **kw) -> "APPOConfig":
        super().training(**kw)
        if target_update_frequency is not None:
            self.target_update_frequency = target_update_frequency
        return self


class APPO(Impala):
    config_class = APPOConfig

    def setup(self, config):
        super().setup(config)
        self._batches_since_target = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        metrics: Dict[str, Any] = {}
        steps = 0
        for _ in range(cfg.num_batches_per_step):
            batch = self._next_batch()
            if batch is None:
                break
            # PPO-style multi-epoch minibatch SGD on the async batch; the
            # clip term bounds the off-policy drift the pipelining causes.
            m = self.learner.update(
                batch, minibatch_size=min(cfg.minibatch_size, len(batch)),
                num_epochs=cfg.num_epochs, seed=cfg.seed + self._iteration)
            steps += len(batch)
            metrics.update(m)
            self._batches_since_target += 1
            if self._batches_since_target >= cfg.target_update_frequency:
                # Refresh the behavior anchor everywhere (the reference
                # updates its target net + broadcasts on the same cadence).
                self._push_weights()
                self._batches_since_target = 0
        metrics["num_env_steps_sampled"] = steps
        return metrics
