"""Replay buffers (reference: rllib/utils/replay_buffers/).

The port's own copy of ``ray_tpu/rllib/replay_buffer.py`` (numpy only)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_samples


class ReplayBuffer:
    """FIFO ring buffer of timesteps with uniform sampling."""

    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        self.capacity = capacity
        self._batches: List[SampleBatch] = []
        self._size = 0
        self._rng = np.random.RandomState(seed)

    def add(self, batch: SampleBatch):
        self._batches.append(batch)
        self._size += len(batch)
        while self._size > self.capacity and self._batches:
            old = self._batches[0]
            excess = self._size - self.capacity
            if len(old) <= excess:
                self._batches.pop(0)
                self._size -= len(old)
            else:
                self._batches[0] = old.slice(excess, len(old))
                self._size -= excess

    def __len__(self):
        return self._size

    def sample(self, num_items: int) -> SampleBatch:
        if not self._batches:
            return SampleBatch()
        merged = concat_samples(self._batches)
        self._batches = [merged]
        idx = self._rng.randint(0, len(merged), size=num_items)
        return SampleBatch({k: v[idx] for k, v in merged.items()})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization (reference:
    replay_buffers/prioritized_replay_buffer.py), simple array impl."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self._alpha = alpha
        self._prios: List[np.ndarray] = []
        self._max_prio = 1.0

    def add(self, batch: SampleBatch):
        super().add(batch)
        self._prios.append(np.full(len(batch), self._max_prio))
        total = sum(len(p) for p in self._prios)
        while total > self._size:
            excess = total - self._size
            if len(self._prios[0]) <= excess:
                total -= len(self._prios[0])
                self._prios.pop(0)
            else:
                self._prios[0] = self._prios[0][excess:]
                total -= excess

    def sample(self, num_items: int, beta: float = 0.4) -> SampleBatch:
        if not self._batches:
            return SampleBatch()
        merged = concat_samples(self._batches)
        self._batches = [merged]
        prios = np.concatenate(self._prios) if self._prios else \
            np.ones(len(merged))
        self._prios = [prios]
        p = prios[:len(merged)] ** self._alpha
        p = p / p.sum()
        idx = self._rng.choice(len(merged), size=num_items, p=p)
        weights = (len(merged) * p[idx]) ** (-beta)
        weights = weights / weights.max()
        out = SampleBatch({k: v[idx] for k, v in merged.items()})
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx
        return out

    def update_priorities(self, idx: np.ndarray, prios: np.ndarray):
        if not self._prios:
            return
        arr = self._prios[0]
        arr[idx] = prios
        self._max_prio = max(self._max_prio, float(prios.max()))
