"""BackendExecutor: drives a WorkerGroup through a training run; the
counterpart of ``ray_tpu/train/backend_executor.py``.

``BackendConfig``, ``TrainingFailedError`` and ``BackendExecutor`` (the
rank mapping of ``_contexts``, ``start_training``, ``get_next_results``,
``_interrupt``, ``shutdown`` and the preemption classification from the
runtime's drain events) are JAX's, over the runtime the caller hands in
(``worker_group``'s doc). ``CudaBackendConfig`` takes the place of
``JaxBackendConfig``: it binds each worker's card and forms the
``torch.distributed`` group of the gang (NCCL on the cards, gloo on the
CPU) where JAX initialises ``jax.distributed``.
"""

from __future__ import annotations

import datetime
import importlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.train.worker_group import WorkerGroup, runtime_attr


@dataclass
class BackendConfig:
    """Base backend config; subclass hooks run on start/shutdown."""

    def on_start(self, executor: "BackendExecutor") -> None:  # noqa: D401
        pass

    def on_shutdown(self, executor: "BackendExecutor") -> None:
        pass


# Process state of a worker, kept in this module as the process imported
# it (_process(); session's doc says why): the environment _join replaced
# ({name: the value before, or None}, put back by _leave), and worker 0's
# rendezvous store, from _open_store until _leave.
_saved_env: Dict[str, Optional[str]] = {}
_store = None
# The rendezvous's and every collective's timeout: a hung gang fails
# (NCCL's error handling tears the worker down) rather than wedging.
_TIMEOUT = datetime.timedelta(minutes=10)


def _process():
    """This module as this process imported it."""
    return importlib.import_module(__name__)


def _export(**env: str) -> None:
    saved = _process()._saved_env
    for name, value in env.items():
        saved.setdefault(name, os.environ.get(name))
        os.environ[name] = value


def _open_store(host: str, port: int, world: int) -> int:
    """On worker 0: serve the gang's rendezvous store on ``port`` (0: a
    port the bind picks) and keep it. -> its port. The store holds the
    port from the bind on, so no other process can take it between a
    probe of a free port and the rendezvous."""
    from torch.distributed import TCPStore
    store = _process()._store = TCPStore(
        host, port, world, is_master=True,
        timeout=_TIMEOUT, wait_for_workers=False)
    return store.port


def _join(rank: int, world: int, ctx: TrainContext, platform: str,
          coordinator: Optional[str]) -> None:
    """On a worker: export the torchrun-style environment, bind
    ``cuda:<local rank>`` before anything else touches CUDA, and join the
    gang's group through the store at ``coordinator`` (None: no group)."""
    from torch.distributed import TCPStore

    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.parallel.mp_check import init_process
    from ray_tpu_torch.train.worker_group import bind_card
    _export(RANK=str(rank), WORLD_SIZE=str(world),
            LOCAL_RANK=str(ctx.local_rank),
            LOCAL_WORLD_SIZE=str(ctx.local_world_size))
    if platform == "cuda":
        resolve_device(None)
        bind_card(ctx.local_rank)
    if coordinator is not None:
        host, port = coordinator.rsplit(":", 1)
        _export(MASTER_ADDR=host, MASTER_PORT=port)
        # A collective that outlives _TIMEOUT tears the process down: a
        # hung gang becomes a lost worker (TrainingFailedError).
        if "TORCH_NCCL_ASYNC_ERROR_HANDLING" not in os.environ:
            _export(TORCH_NCCL_ASYNC_ERROR_HANDLING="1")
        store = _process()._store if rank == 0 else TCPStore(
            host, int(port), world, is_master=False, timeout=_TIMEOUT)
        init_process(rank, world, coordinator, 1, platform,
                     timeout=_TIMEOUT, store=store)


def _leave() -> bool:
    """On a worker: leave the group, unbind the card and put back the
    environment _join replaced (a gang of one lives in the caller's
    process)."""
    import torch.distributed as dist

    from ray_tpu_torch.train.worker_group import bind_card
    if dist.is_initialized():
        dist.destroy_process_group()
    here = _process()
    here._store = None
    bind_card(None)
    for name, value in here._saved_env.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
    here._saved_env.clear()
    return True


@dataclass
class CudaBackendConfig(BackendConfig):
    """Binds each worker's card and forms the gang's process group.

    distributed: "auto" forms the group whenever the world is larger than
    one; "force" forms it even for a world of one; "off" never. This is
    where the card differs from the TPU: on a TPU host one process owns
    every chip, so JAX's "auto" forms no gang on one host, while here one
    process owns one card, so workers on one host are a gang of processes
    like workers on many.

    platform: "cuda" binds ``cuda:<local rank>`` on each worker (with
    ``torch.cuda.set_device``, before anything else touches CUDA; rank r of
    one host on cuda:r, as ``parallel.mesh.build_mesh`` maps ranks) and
    forms an NCCL group; "cpu" binds no card and forms a gloo group. The
    group meets at a store that worker 0 serves on ``coordinator_port``
    (0: the port its bind picks; JAX probes a free port first, and another
    process can take a probed port before the rendezvous binds it), and its
    collectives time out after ten minutes. Each worker also gets the
    torchrun environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    and MASTER_ADDR/MASTER_PORT with a group).
    """

    distributed: str = "auto"  # auto | off | force
    coordinator_port: int = 0  # 0 = the port worker 0's store binds
    platform: str = "cuda"     # cuda | cpu

    def on_start(self, executor: "BackendExecutor") -> None:
        if self.distributed not in ("auto", "off", "force"):
            raise ValueError(f"distributed {self.distributed!r}: 'auto', "
                             "'off' or 'force'")
        if self.platform not in ("cuda", "cpu"):
            raise ValueError(f"platform {self.platform!r}: 'cuda' or 'cpu'")
        if self.platform == "cpu" and executor.scaling.use_gpu:
            raise ValueError("use_gpu=True reserves a card for each worker; "
                             "platform='cpu' runs on none")
        world = executor.world_size
        group = self.distributed == "force" or (
            self.distributed == "auto" and world > 1)
        wg = executor.worker_group
        rt = wg.runtime
        coordinator = None
        if group:
            # The group meets at worker 0's store, which binds its port
            # itself (_open_store).
            host = executor.node_info_per_worker[0]["ip"]
            port = rt.get(wg.workers[0].execute.remote(
                _open_store, host, self.coordinator_port, world), timeout=60)
            coordinator = f"{host}:{port}"
        refs = [w.execute.remote(_join, rank, world, ctx, self.platform,
                                 coordinator)
                for rank, (w, ctx) in enumerate(zip(wg.workers,
                                                    executor._contexts()))]
        rt.get(refs, timeout=_TIMEOUT.total_seconds() + 60)

    def on_shutdown(self, executor: "BackendExecutor") -> None:
        wg = executor.worker_group
        try:
            wg.runtime.get([w.execute.remote(_leave) for w in wg.workers],
                           timeout=10)
        except Exception:  # noqa: BLE001 — a lost or hung worker is killed
            pass


class TrainingFailedError(RuntimeError):
    """A training attempt failed. ``preempted`` marks attempts lost to a
    planned node drain: the Trainer retries those without charging
    FailureConfig.max_failures (unless fail_on_preemption).
    ``device_error``: the loop died of a CUDA error, which no later run in
    the same process can recover from."""

    def __init__(self, *args, preempted: bool = False,
                 device_error: bool = False):
        self.preempted = preempted
        self.device_error = device_error
        super().__init__(*args)


class BackendExecutor:
    """``runtime``: what hosts the workers (``worker_group``'s doc)."""

    def __init__(self, scaling: ScalingConfig,
                 backend: Optional[BackendConfig] = None,
                 experiment_name: str = "", storage_path: str = "",
                 trial_id: str = "", runtime=None):
        self.scaling = scaling
        self.backend = backend or CudaBackendConfig()
        self.experiment_name = experiment_name
        self.storage_path = storage_path
        self.trial_id = trial_id
        self.runtime = runtime
        self.worker_group: Optional[WorkerGroup] = None
        self.node_info_per_worker: List[dict] = []
        self.world_size = scaling.num_workers

    def start(self):
        self._started_at = time.time()
        self._save_pushed = False
        self.worker_group = WorkerGroup(
            self.scaling.num_workers, self.scaling.worker_resources(),
            self.scaling.placement_strategy, runtime=self.runtime)
        self.node_info_per_worker = self.worker_group.node_infos()
        self.backend.on_start(self)
        self._start_preempt_watcher()

    def _worker_api(self, name: str):
        return runtime_attr(self.worker_group.runtime,
                            "_private.worker_api." + name)

    # ---- driver-side preemption watcher ----

    def _start_preempt_watcher(self):
        """Watch the runtime's drain-event log so that save-on-preempt fires
        even when only the driver sees the notice: a push wakeup where the
        runtime offers a listener (a slow poll as the fallback), else a
        0.25 s poll. A runtime without drain events starts no watcher."""
        self._stop_preempt_watcher()  # restart attempts re-arm cleanly
        if self._worker_api("drain_events") is None:
            return
        self._watch_stop = threading.Event()
        kick = self._watch_kick = threading.Event()

        def _listener():
            kick.set()

        self._watch_listener = _listener
        add = self._worker_api("add_drain_event_listener")
        try:
            subscribed = bool(add(_listener)) if add is not None else False
        except Exception:  # noqa: BLE001 — not connected
            subscribed = False
        poll_s = 5.0 if subscribed else 0.25

        def _loop():
            while not self._watch_stop.is_set():
                kick.wait(poll_s)  # push wakeup; timeout = poll fallback
                kick.clear()
                if self._watch_stop.is_set() or self._save_pushed:
                    return
                try:
                    if self._preempted_since_start():
                        self._save_pushed = True
                        self.request_save()
                        return
                except Exception:  # noqa: BLE001 — watcher must not die
                    pass

        self._watcher = threading.Thread(
            target=_loop, daemon=True, name="train-preempt-watcher")
        self._watcher.start()

    def _stop_preempt_watcher(self):
        stop = getattr(self, "_watch_stop", None)
        if stop is not None:
            stop.set()
        kick = getattr(self, "_watch_kick", None)
        if kick is not None:
            kick.set()  # unblock the wait so the thread exits promptly
        listener = getattr(self, "_watch_listener", None)
        if listener is not None:
            remove = self._worker_api("remove_drain_event_listener")
            try:
                if remove is not None:
                    remove(listener)
            except Exception:  # noqa: BLE001
                pass
            self._watch_listener = None
        watcher = getattr(self, "_watcher", None)
        if watcher is not None:
            watcher.join(timeout=2.0)
            self._watcher = None

    def _preempted_since_start(self) -> bool:
        """Did a node hosting this gang receive a drain notice after this
        attempt started? Failures observed afterwards classify as planned
        loss; events for other nodes do not."""
        if self.worker_group is None:
            return False
        drain_events = self._worker_api("drain_events")
        if drain_events is None:
            return False
        try:
            events = drain_events()
        except Exception:  # noqa: BLE001 — not connected
            return False
        start = getattr(self, "_started_at", 0.0)
        gang_nodes = {i.get("node_id", "") for i in self.node_info_per_worker}
        gang_nodes.discard("")

        def _hexes(ev) -> list:
            ids = ev.get("node_ids") or [ev.get("node_id")]
            return [nid.hex() if hasattr(nid, "hex") else str(nid or "")
                    for nid in ids]

        for ev in events:
            if ev.get("time", 0.0) < start:
                continue
            # Unknown gang placement: keep the permissive classification.
            if not gang_nodes or gang_nodes & set(_hexes(ev)):
                return True
        return False

    def request_save(self):
        """Best-effort save-on-preempt push to every gang worker."""
        for w in self.worker_group.workers if self.worker_group else []:
            try:
                w.request_save.remote()
            except Exception:  # noqa: BLE001 — worker may be mid-restart
                pass

    def _contexts(self) -> List[TrainContext]:
        """Global rank = position; local rank = index within its node."""
        by_node: Dict[str, List[int]] = {}
        for i, info in enumerate(self.node_info_per_worker):
            by_node.setdefault(info["hostname"], []).append(i)
        node_order = sorted(by_node)
        ctxs = []
        for rank, info in enumerate(self.node_info_per_worker):
            host = info["hostname"]
            ctxs.append(TrainContext(
                world_size=self.world_size, world_rank=rank,
                local_rank=by_node[host].index(rank),
                local_world_size=len(by_node[host]),
                node_rank=node_order.index(host),
                experiment_name=self.experiment_name,
                storage_path=self.storage_path, trial_id=self.trial_id))
        return ctxs

    def start_training(self, train_fn: Callable, config: Optional[dict],
                       checkpoint: Optional[Checkpoint] = None,
                       datasets_per_worker: Optional[List[dict]] = None):
        refs = []
        for i, (w, ctx) in enumerate(zip(self.worker_group.workers,
                                         self._contexts())):
            ds = datasets_per_worker[i] if datasets_per_worker else None
            refs.append(w.start_run.remote(train_fn, config, ctx,
                                           checkpoint, ds))
        self.worker_group.runtime.get(refs, timeout=60)

    def get_next_results(self, timeout: float = 600.0) -> Optional[List[dict]]:
        """One result per worker for this round, or None when all done.

        Raises TrainingFailedError if any worker errored.
        """
        rt = self.worker_group.runtime
        deadline = time.monotonic() + timeout
        results: List[Optional[dict]] = [None] * len(self.worker_group.workers)
        pending = set(range(len(results)))
        finished: Dict[int, dict] = {}
        if not self._save_pushed and self._preempted_since_start():
            self._save_pushed = True
            self.request_save()
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("timed out waiting for train results")
            refs = {i: self.worker_group.workers[i].poll.remote(
                min(5.0, remaining)) for i in pending}
            for i, ref in refs.items():
                try:
                    out = rt.get(ref, timeout=30)
                except Exception as e:  # noqa: BLE001 — gang worker lost
                    self._interrupt()
                    raise TrainingFailedError(
                        f"{type(e).__name__}: {e}",
                        preempted=(getattr(e, "preempted", False)
                                   or self._preempted_since_start()))
                if out is None:
                    continue
                if out["type"] == "error":
                    self._interrupt()
                    raise TrainingFailedError(
                        out["error"],
                        preempted=self._preempted_since_start(),
                        device_error=out.get("device_error", False))
                if out["type"] == "done":
                    finished[i] = out
                    pending.discard(i)
                else:
                    results[i] = out
                    pending.discard(i)
        if finished and len(finished) == len(results):
            return None
        if finished:
            # Mixed done/report: treat stragglers' reports as the last round.
            return [r for r in results if r is not None] or None
        return results

    def _interrupt(self):
        for w in self.worker_group.workers:
            try:
                w.interrupt.remote()
            except Exception:  # noqa: BLE001
                pass

    def shutdown(self):
        self._stop_preempt_watcher()
        if self.worker_group is not None:
            self.backend.on_shutdown(self)
            self.worker_group.shutdown()
            self.worker_group = None
