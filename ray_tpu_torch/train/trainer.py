"""Trainer: the counterpart of ``ray_tpu/train/trainer.py``'s
``JaxTrainer``, with ``Result`` and top-K checkpoint bookkeeping.

The per-worker train fn builds its mesh and train step itself
(``parallel.build_mesh``, ``train.init_train_state``,
``train.make_train_step``); the backend only binds each worker's card and
forms the gang's process group (``CudaBackendConfig``). Fault tolerance is
gang-granular, as in JAX: on a failure the whole worker group restarts
from the latest checkpoint, with JAX's retry accounting.

Named ``Trainer``, not ``TorchTrainer``: the JAX package's ``TorchTrainer``
(``ray_tpu/train/torch.py``) is another harness (gloo DDP).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.backend_executor import (BackendConfig,
                                                  BackendExecutor,
                                                  CudaBackendConfig,
                                                  TrainingFailedError)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (CheckpointConfig, RunConfig,
                                        ScalingConfig)

logger = logging.getLogger(__name__)


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    path: str = ""
    error: Optional[str] = None
    metrics_dataframe: Optional[List[Dict[str, Any]]] = None

    @property
    def best_checkpoints(self):
        return self._best_checkpoints

    _best_checkpoints: List = field(default_factory=list)


class _CheckpointBook:
    """Top-K retention (CheckpointConfig.num_to_keep); an evicted
    checkpoint's directory is deleted."""

    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self.entries: List[tuple] = []  # (score, seq, ckpt, metrics)
        self._seq = 0

    def register(self, ckpt: Checkpoint, metrics: Dict[str, Any]):
        attr = self.cfg.checkpoint_score_attribute
        if attr is not None and attr in metrics:
            score = float(metrics[attr])
            if self.cfg.checkpoint_score_order == "min":
                score = -score
        else:
            score = float(self._seq)  # recency
        self.entries.append((score, self._seq, ckpt, dict(metrics)))
        self._seq += 1
        k = self.cfg.num_to_keep
        if k is not None and len(self.entries) > k:
            self.entries.sort(key=lambda e: (e[0], e[1]))
            evicted = self.entries.pop(0)
            shutil.rmtree(evicted[2].path, ignore_errors=True)

    def latest(self) -> Optional[Checkpoint]:
        if not self.entries:
            return None
        return max(self.entries, key=lambda e: e[1])[2]

    def best(self) -> Optional[Checkpoint]:
        if not self.entries:
            return None
        return max(self.entries, key=lambda e: (e[0], e[1]))[2]


class Trainer:
    """Runs ``train_loop_per_worker`` on a gang of workers, one card each:
    JAX's ``JaxTrainer``.

    train_loop_per_worker() (or (config)) calls ``train.report(...)`` once
    per round; rank-0 metrics become the Result rows. ``runtime``: what
    hosts the workers, ``ray_tpu`` (after ``ray_tpu.init()``: one actor per
    worker) or None (a gang of one in this process, the loop on its
    ``train_loop`` thread; ``worker_group``'s doc).

    The backend defaults to ``CudaBackendConfig()``: each worker binds its
    card, and ``use_gpu=True`` without CUDA raises. On the CPU, pass
    ``backend_config=CudaBackendConfig(platform="cpu")`` and build the
    loop's model and mesh on ``"cpu"``.

    In process, a failed attempt's worker is stopped and its run freed
    before the next attempt starts. A CUDA error is sticky (the process's
    CUDA context is lost), so an in-process restart cannot recover from
    one: only a Python exception raised in the loop is retried there; a
    CUDA error ends the fit. With a runtime, a restart makes new worker
    processes and retries either.
    """

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 backend_config: Optional[BackendConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 runtime=None):
        self.train_fn = train_loop_per_worker
        self.train_config = train_loop_config
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend_config = backend_config or CudaBackendConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint
        self.runtime = runtime
        if self.run_config.name is None:
            self.run_config.name = f"Trainer_{int(time.time())}"
        if self.run_config.storage_path is None:
            self.run_config.storage_path = os.path.join(
                tempfile.gettempdir(), "ray_tpu_torch_results")

    # -- data ingestion: split datasets across workers ----------------------

    def _datasets_per_worker(self) -> Optional[List[dict]]:
        if not self.datasets:
            return None
        n = self.scaling.num_workers
        per_worker: List[dict] = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                shards = ds.streaming_split(n)
            elif hasattr(ds, "split"):
                shards = ds.split(n)
            else:
                shards = [ds] * n
            for i in range(n):
                per_worker[i][name] = shards[i]
        return per_worker

    # Backstop for pathological clusters that preempt every single attempt:
    # uncharged (preemption) retries are not infinite in practice.
    _MAX_UNCHARGED_ATTEMPTS = 50

    @staticmethod
    def _failure_cause_class(err: str) -> str:
        """Best-effort failure *cause class* from a remote traceback string
        (the last line of a formatted traceback is 'Class: message')."""
        last = err.strip().splitlines()[-1] if err and err.strip() else ""
        head = last.split(":", 1)[0].strip()
        return head if head and " " not in head else "unknown"

    def fit(self) -> Result:
        failure = self.run_config.failure_config
        book = _CheckpointBook(self.run_config.checkpoint_config)
        rows: List[Dict[str, Any]] = []
        start_ckpt = self.resume_from_checkpoint
        err: Optional[str] = None
        exp_path = os.path.join(self.run_config.storage_path,
                                self.run_config.name)
        os.makedirs(exp_path, exist_ok=True)

        attempt = 0
        charged = 0   # failures counted against FailureConfig.max_failures
        while True:
            attempt += 1
            executor = BackendExecutor(
                self.scaling, self.backend_config,
                experiment_name=self.run_config.name,
                storage_path=self.run_config.storage_path,
                trial_id=f"attempt_{attempt - 1}", runtime=self.runtime)
            try:
                executor.start()
                executor.start_training(
                    self.train_fn, self.train_config,
                    checkpoint=book.latest() or start_ckpt,
                    datasets_per_worker=self._datasets_per_worker())
                while True:
                    round_results = executor.get_next_results()
                    if round_results is None:
                        break
                    rank0 = next((r for r in round_results
                                  if r.get("rank") == 0), round_results[0])
                    rows.append(rank0["metrics"])
                    ckpts = [r["checkpoint"] for r in round_results
                             if r.get("checkpoint") is not None]
                    if ckpts:
                        book.register(ckpts[0], rank0["metrics"])
                err = None
                break
            except TrainingFailedError as e:
                err = str(e)
                preempted = getattr(e, "preempted", False)
                charge = failure.fail_on_preemption or not preempted
                if charge:
                    charged += 1
                logger.warning(
                    "training attempt %d failed (cause=%s, %s; "
                    "%d/%s failures charged): %s",
                    attempt, self._failure_cause_class(err),
                    "charged" if charge
                    else "uncharged: preemption/drain",
                    charged,
                    failure.max_failures if failure.max_failures >= 0
                    else "inf",
                    err.splitlines()[-1] if err else "")
                out_of_budget = (failure.max_failures >= 0
                                 and charged > failure.max_failures)
                sticky = self.runtime is None and e.device_error
                if sticky:
                    logger.warning("a CUDA error is sticky: the gang of one "
                                   "in this process cannot restart")
                # The backstop bounds only UNCHARGED (preemption) retries;
                # charged attempts are governed solely by max_failures
                # (max_failures=-1 keeps its effectively-infinite budget).
                if out_of_budget or sticky \
                        or attempt - charged >= self._MAX_UNCHARGED_ATTEMPTS:
                    break
            finally:
                executor.shutdown()

        result = Result(metrics=rows[-1] if rows else {},
                        checkpoint=book.best() or book.latest(),
                        path=exp_path, error=err,
                        metrics_dataframe=rows)
        result._best_checkpoints = [(c, m) for _, _, c, m in
                                    sorted(book.entries, key=lambda e: e[1])]
        if err is not None:
            raise TrainingFailedError(err)
        return result
