"""SampleBatch: columnar trajectory storage.

The port's own copy of ``ray_tpu/rllib/sample_batch.py`` (numpy only; the
port imports nothing of ``ray_tpu``). Reference parity:
rllib/policy/sample_batch.py:99 (standard keys, concat, minibatch
iteration). Columns are numpy arrays; a learner moves the columns it reads
to its device once per update and takes minibatches there, in the order
``minibatch_indices`` draws.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
TERMINATEDS = "terminateds"
TRUNCATEDS = "truncateds"
NEXT_OBS = "next_obs"
LOGPS = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
EPS_ID = "eps_id"
# Recurrent-model columns (reference: SampleBatch "state_in_*" keys +
# the seq_lens machinery; here sequences are fixed-length fragments).
DONE_PREV = "done_prev"
STATE_IN_H = "state_in_h"
STATE_IN_C = "state_in_c"


class SampleBatch(dict):
    """dict[str, np.ndarray] with batch helpers."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    def __len__(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @property
    def count(self) -> int:
        return len(self)

    def shuffle(self, seed: Optional[int] = None) -> "SampleBatch":
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(self))
        return SampleBatch({k: v[idx] for k, v in self.items()})

    def minibatches(self, minibatch_size: int,
                    num_epochs: int = 1,
                    seed: Optional[int] = None) -> Iterator["SampleBatch"]:
        for sel in minibatch_indices(len(self), minibatch_size, num_epochs,
                                     seed):
            yield SampleBatch({k: v[sel] for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})


def minibatch_indices(n: int, minibatch_size: int, num_epochs: int = 1,
                      seed: Optional[int] = None) -> Iterator[np.ndarray]:
    """Row indices of each minibatch: per epoch one permutation of range(n)
    from ``RandomState(seed)``, cut into whole minibatches (a short tail is
    dropped), as the reference's ``SampleBatch.minibatches`` draws them."""
    rng = np.random.RandomState(seed)
    for _ in range(num_epochs):
        idx = rng.permutation(n)
        for start in range(0, n - minibatch_size + 1, minibatch_size):
            yield idx[start:start + minibatch_size]


def concat_samples(batches: List[SampleBatch]) -> SampleBatch:
    batches = [b for b in batches if len(b)]
    if not batches:
        return SampleBatch()
    keys = batches[0].keys()
    return SampleBatch({k: np.concatenate([b[k] for b in batches])
                        for k in keys})


BOOTSTRAP_VALUES = "bootstrap_values"


def compute_gae(batch: SampleBatch, last_value: float, gamma: float,
                lam: float) -> SampleBatch:
    """Generalized advantage estimation over one rollout fragment.

    Reference parity: rllib/evaluation/postprocessing.py
    (compute_advantages). Episode boundaries inside the fragment cut the
    recursion; truncated (not terminated) steps bootstrap from
    batch["bootstrap_values"] — V(s_{t+1}) computed by the env runner
    BEFORE the env reset — and the fragment tail bootstraps from
    last_value.
    """
    rewards = batch[REWARDS]
    values = batch[VF_PREDS]
    terminateds = batch[TERMINATEDS]
    truncateds = batch.get(TRUNCATEDS, np.zeros_like(terminateds))
    bootstrap = batch.get(BOOTSTRAP_VALUES, np.zeros_like(values))
    n = len(rewards)
    adv = np.zeros(n, dtype=np.float32)
    last_gae = 0.0
    for t in reversed(range(n)):
        if terminateds[t]:
            delta = rewards[t] - values[t]
            last_gae = delta
        elif truncateds[t]:
            delta = rewards[t] + gamma * bootstrap[t] - values[t]
            last_gae = delta
        else:
            next_v = last_value if t == n - 1 else values[t + 1]
            delta = rewards[t] + gamma * next_v - values[t]
            last_gae = delta + gamma * lam * last_gae
        adv[t] = last_gae
    batch[ADVANTAGES] = adv
    batch[VALUE_TARGETS] = (adv + values).astype(np.float32)
    return batch


class MultiAgentBatch:
    """Per-policy SampleBatches plus the env-step count they came from.

    Reference parity: rllib/policy/sample_batch.py:1338 (MultiAgentBatch).
    `policy_batches` maps policy id -> SampleBatch; `env_steps` counts
    environment steps (agents stepping simultaneously share one env step),
    while agent_steps() sums per-agent transitions.
    """

    def __init__(self, policy_batches: dict, env_steps: int):
        self.policy_batches = dict(policy_batches)
        self.count = int(env_steps)

    def env_steps(self) -> int:
        return self.count

    def agent_steps(self) -> int:
        return sum(len(b) for b in self.policy_batches.values())

    def __len__(self):
        return self.count

    @staticmethod
    def wrap_as_needed(batch, env_steps: int) -> "MultiAgentBatch":
        if isinstance(batch, MultiAgentBatch):
            return batch
        return MultiAgentBatch({"default_policy": batch}, env_steps)

    @staticmethod
    def concat_samples(batches: list) -> "MultiAgentBatch":
        merged: dict = {}
        steps = 0
        for mb in batches:
            steps += mb.env_steps()
            for pid, b in mb.policy_batches.items():
                merged.setdefault(pid, []).append(b)
        return MultiAgentBatch(
            {pid: concat_samples(bs) for pid, bs in merged.items()}, steps)

    def __repr__(self):
        sizes = {p: len(b) for p, b in self.policy_batches.items()}
        return f"MultiAgentBatch(env_steps={self.count}, policies={sizes})"
