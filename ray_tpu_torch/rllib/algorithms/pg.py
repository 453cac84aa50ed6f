"""PG's learner: the port of ``ray_tpu/rllib/algorithms/pg.py:43``.

Reference parity: rllib/algorithms/pg — vanilla REINFORCE: the gradient
weights each action's log-prob by the empirical discounted return. The
runners' GAE runs with lambda=1 so VALUE_TARGETS is the Monte-Carlo
return, and the caller sets ``batch[ADVANTAGES] = batch[VALUE_TARGETS]``
before the update, as ``PG.training_step`` does.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.a2c import A2CLearner


class PGLearner(A2CLearner):
    """A2C's vanilla -logp*adv gradient; PG feeds it returns instead of
    advantages (the whitening in the shared loss is a constant baseline,
    which keeps the REINFORCE gradient unbiased)."""
