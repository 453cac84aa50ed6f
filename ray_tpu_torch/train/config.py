"""Train configuration dataclasses: the counterpart of
``ray_tpu/train/config.py``.

``FailureConfig``, ``CheckpointConfig`` (with JAX's ``ValueError``
messages) and ``RunConfig`` are copied as they are. ``ScalingConfig``
differs where the device does: a TPU worker owns every chip of its host,
while a torch process owns one device, so a worker here owns one card.
``use_tpu``/``tpus_per_worker`` become ``use_gpu``, one accelerator slot a
worker (``"GPU": 1`` in ``worker_resources`` and in each placement-group
bundle; the worker group books it under the runtime's own name for an
accelerator slot).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    """How many train workers and what each reserves.

    num_workers: one worker per card; ``use_gpu`` reserves that card (one
    accelerator slot) for each worker.
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    trainer_resources: Optional[Dict[str, float]] = None

    def worker_resources(self) -> Dict[str, float]:
        res: Dict[str, float] = {"CPU": 1.0}
        if self.resources_per_worker:
            res = {k: float(v) for k, v in self.resources_per_worker.items()}
            res.setdefault("CPU", 0.0)
        if self.use_gpu:
            res["GPU"] = 1.0
        return res

    def as_placement_group_bundles(self):
        return [self.worker_resources() for _ in range(self.num_workers)]


@dataclass
class FailureConfig:
    """max_failures: retries of the whole training run (gang restart:
    one worker's loss restarts every worker).

    fail_on_preemption: False (default) means gang restarts caused by a
    *planned* node loss (a drain notice the runtime reports) do NOT count
    against max_failures. Set True to charge them like any other failure.
    """

    max_failures: int = 0
    fail_on_preemption: bool = False


@dataclass
class CheckpointConfig:
    """Top-K checkpoint retention."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 0
    # Tune stop criteria: {"training_iteration": N} / {metric: threshold}.
    stop: Optional[Dict[str, float]] = None
