"""A2C's learner: the port of ``ray_tpu/rllib/algorithms/a2c.py:38``.

Reference parity: rllib/algorithms/a2c/a2c.py — the PPO pipeline minus
importance ratios and clipping: vanilla policy gradient with the GAE
advantage baseline the EnvRunners already compute. Only the
policy-gradient term differs from PPOLearner; the algorithm's training loop
(``A2C``, a ``tune.Trainable``) is orchestration and is not ported.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.learner import PPOLearner


class A2CLearner(PPOLearner):
    """PPOLearner with the vanilla advantage policy gradient (no
    importance ratio / clipping); minibatch/epoch handling inherited."""

    def _pg_loss(self, logp, old_logp, adv):
        return -(logp * adv).mean()
