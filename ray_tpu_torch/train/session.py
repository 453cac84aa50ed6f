"""Per-worker training session: the counterpart of
``ray_tpu/train/session.py`` (report, get_checkpoint, get_context).

The train loop runs on the worker's ``train_loop`` thread and calls
``report`` once per logging interval; the step itself never touches the
session. ``report`` blocks until the driver consumes the previous result
(a queue of size 1), which keeps the workers of a gang in lockstep with
the driver's bookkeeping.

``should_checkpoint``'s drain check asks the runtime: the worker group
hands each session the runtime's probe of its node's drain notice (with
``runtime=ray_tpu``, ``ray_tpu._private.worker_api.local_node_draining``).
Without a runtime there is no drain notice, and it is False unless the
driver requested a save.

The session is process state, and it lives in this module as the process
imported it (``_process()``): ``ray_tpu`` ships modules from outside
site-packages by value (``ray_tpu/_private/serialization.py``), so a worker
may run copies of the port's functions, each with its own globals, beside
the imported module.
"""

from __future__ import annotations

import importlib
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class TrainContext:
    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    experiment_name: str = ""
    storage_path: str = ""
    trial_id: str = ""

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_id(self) -> str:
        return self.trial_id

    def get_storage_path(self) -> str:
        return self.storage_path


class _Session:
    """Lives inside the train worker; bridges the user's train fn (running
    on the ``train_loop`` thread) and the driver's polling."""

    def __init__(self, context: TrainContext,
                 checkpoint: Optional[Checkpoint] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 draining: Optional[Callable[[], bool]] = None):
        self.context = context
        self.starting_checkpoint = checkpoint
        self.datasets = datasets or {}
        self._draining = draining
        self._results: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        # Save-on-preempt: set by TrainWorker.request_save (driver push) or
        # implied by a drain notice for this worker's node; cleared when a
        # checkpoint is reported.
        self._save_requested = threading.Event()

    # -- called from the user train fn (train_loop thread) --

    def should_checkpoint(self) -> bool:
        """True when the training loop should save now: the driver
        requested a save, or the runtime reports a drain notice for this
        worker's node."""
        if self._save_requested.is_set():
            return True
        if self._draining is None:
            return False
        try:
            return bool(self._draining())
        except Exception:  # noqa: BLE001 — the probe is best effort
            return False

    def request_save(self):
        self._save_requested.set()

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        if self._stop.is_set():
            raise _StopTraining()
        if checkpoint is not None:
            self._save_requested.clear()
        self._results.put({"type": "report", "metrics": dict(metrics),
                           "checkpoint": checkpoint,
                           "rank": self.context.world_rank})

    def finish(self, value: Any = None, error: Optional[str] = None,
               device_error: bool = False):
        """``device_error``: the loop died of a CUDA error (sticky: no run
        in this process can use the card again)."""
        self._results.put({"type": "error", "error": error,
                           "device_error": device_error}
                          if error else {"type": "done", "value": value})

    # -- called from the worker's call threads --

    def next_result(self, timeout: float = 10.0) -> Optional[dict]:
        try:
            return self._results.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self):
        self._stop.set()


class _StopTraining(Exception):
    pass


_session: Optional[_Session] = None


def _process():
    """This module as this process imported it (module doc)."""
    return importlib.import_module(__name__)


def _set_session(s: Optional[_Session]):
    _process()._session = s


def _get_session() -> Optional[_Session]:
    return _process()._session


def get_context() -> TrainContext:
    s = _get_session()
    return TrainContext() if s is None else s.context


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and a checkpoint) for this round; blocks until the
    driver has consumed the previous round."""
    s = _get_session()
    if s is None:
        raise RuntimeError("train.report() called outside a train worker")
    s.report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = _get_session()
    return None if s is None else s.starting_checkpoint


def should_checkpoint() -> bool:
    """Save-on-preempt hook: True when this worker's node is being drained
    and the loop should checkpoint now. Always False outside a train
    worker."""
    s = _get_session()
    return False if s is None else s.should_checkpoint()


def get_dataset_shard(name: str = "train"):
    s = _get_session()
    if s is None:
        raise RuntimeError("get_dataset_shard() outside a train worker")
    ds = s.datasets.get(name)
    if ds is None:
        raise KeyError(f"no dataset shard named '{name}'")
    return ds
