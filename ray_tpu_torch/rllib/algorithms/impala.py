"""IMPALA-style asynchronous PPO: the port of
``ray_tpu/rllib/algorithms/impala.py`` (``ImpalaConfig`` :19, ``Impala``
:35).

Reference parity: rllib/algorithms/impala/impala.py:667 — rollouts are
pipelined: the learner consumes whichever runner finishes first and
immediately re-dispatches it, so sampling and learning overlap and weight
broadcast is off the critical path. Off-policy drift is corrected by the
PPO clip (a lightweight stand-in for V-trace). In process
(``local_runtime``) "first" is submission order, and a re-dispatched
rollout runs at once with the weights its runner holds.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig


class ImpalaConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or Impala)
        self.num_batches_per_step = 4
        self.broadcast_interval = 2

    def training(self, *, num_batches_per_step=None,
                 broadcast_interval=None, **kw) -> "ImpalaConfig":
        super().training(**kw)
        if num_batches_per_step is not None:
            self.num_batches_per_step = num_batches_per_step
        if broadcast_interval is not None:
            self.broadcast_interval = broadcast_interval
        return self


class Impala(PPO):
    config_class = ImpalaConfig

    def setup(self, config):
        super().setup(config)
        cfg = self.algo_config
        # Prime the pipeline: one in-flight rollout per runner.
        self._inflight = {
            er.sample.remote(cfg.rollout_fragment_length, cfg.gamma,
                             self.gae_lambda()): er
            for er in self.env_runners
        }
        self._consumed_since_broadcast = 0

    def _next_batch(self):
        """The first finished rollout, its runner re-dispatched at once
        (async pipelining); None when nothing finished in time."""
        cfg = self.algo_config
        done, _ = self._rt.wait(list(self._inflight.keys()),
                                num_returns=1, timeout=60.0)
        if not done:
            return None
        ref = done[0]
        runner = self._inflight.pop(ref)
        batch = self._rt.get(ref)
        self._inflight[runner.sample.remote(
            cfg.rollout_fragment_length, cfg.gamma,
            self.gae_lambda())] = runner
        return batch

    def _push_weights(self):
        """Off the critical path: fire-and-forget weight pushes."""
        params = self.runner_weights(self.learner.get_weights())
        for er in self.env_runners:
            er.set_weights.remote(params)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        metrics: Dict[str, Any] = {}
        steps = 0
        for _ in range(cfg.num_batches_per_step):
            batch = self._next_batch()
            if batch is None:
                break
            m = self.learner.update(
                batch, minibatch_size=min(cfg.minibatch_size, len(batch)),
                num_epochs=1, seed=cfg.seed + self._iteration)
            steps += len(batch)
            metrics.update(m)
            self._consumed_since_broadcast += 1
            if self._consumed_since_broadcast >= cfg.broadcast_interval:
                self._push_weights()
                self._consumed_since_broadcast = 0
        metrics["num_env_steps_sampled"] = steps
        return metrics
