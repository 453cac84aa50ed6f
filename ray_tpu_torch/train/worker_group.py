"""WorkerGroup: a gang of train workers behind a runtime, the counterpart of
``ray_tpu/train/worker_group.py``.

The port imports nothing of ``ray_tpu``, so the runtime is handed in, as
``Algorithm.build(runtime=...)`` takes it:

- ``runtime=ray_tpu`` (after ``ray_tpu.init()``): each worker is a
  ``ray_tpu`` actor, placed as JAX places them, one bundle a worker on a
  placement group of the given strategy. ``import ray_tpu`` makes
  everything the group reaches through the module reachable:
  ``ray_tpu.util.placement_group``, ``remove_placement_group`` and
  ``PlacementGroupSchedulingStrategy``, and the drain probes of
  ``ray_tpu._private.worker_api`` (``local_node_draining`` for
  ``should_checkpoint``; ``drain_events`` and its listeners for the
  executor's preemption classification). Another runtime object offers
  what it has at the same attribute paths; a path it lacks turns the
  feature off (no placement group, no drain notice).
- No runtime: ``util.local_runtime`` hosts a gang of one in this process.
  ``num_workers > 1`` raises: the port starts no processes of its own.

A worker owns one card. It asks the runtime for one accelerator slot,
``num_gpus=1`` (ray_tpu books it under its accelerator resource, "TPU",
remote_function.py ``_resources_from_options``), and its placement bundle
names the same slot: the one of "GPU" and "TPU" that the runtime's
cluster has. Which card the worker's process binds is the backend's work
(``CudaBackendConfig``: ``cuda:<local rank>``). The train loop runs on the
worker's ``train_loop`` thread, which binds that card again before the
loop starts: a CUDA device is current per thread. The bound card and the
session are process state, kept in the modules as the process imported
them (``_process()``; ``session``'s doc says why).
"""

from __future__ import annotations

import gc
import importlib
import os
import socket
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch

from ray_tpu_torch.train import session as _session_mod
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.util import local_runtime

_ACCELERATOR_NAMES = ("GPU", "TPU")

# The card this process's backend bound (CudaBackendConfig), bound again
# on each train_loop thread; None on the CPU.
_card: Optional[int] = None


def _process():
    """This module as this process imported it (module doc)."""
    return importlib.import_module(__name__)


def runtime_attr(runtime, path: str):
    """``runtime``'s attribute at the dotted ``path``, or None."""
    obj = runtime
    for part in path.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def bind_card(index: Optional[int]) -> None:
    """Make ``cuda:<index>`` this process's card (None: the CPU)."""
    _process()._card = index
    if index is not None:
        torch.cuda.set_device(index)


def _is_device_error(exc: BaseException) -> bool:
    """A CUDA error, which is sticky: the process's CUDA context is lost."""
    kind = getattr(torch, "AcceleratorError", None)
    return ((kind is not None and isinstance(exc, kind))
            or "CUDA error" in str(exc))


class TrainWorker:
    """Hosts one training process (one card). ``draining``: the runtime's
    probe of a drain notice for this worker's node, or None."""

    def __init__(self, draining: Optional[Callable[[], bool]] = None):
        self._draining = draining
        self._session = None
        self._thread: Optional[threading.Thread] = None

    def node_info(self) -> Dict[str, Any]:
        return {"hostname": socket.gethostname(), "pid": os.getpid(),
                "ip": "127.0.0.1",
                "node_id": os.environ.get("RAY_TPU_NODE_ID", "")}

    def set_env(self, env: Dict[str, str]) -> None:
        os.environ.update(env)

    def start_run(self, fn: Callable, config: Optional[dict],
                  context: TrainContext,
                  checkpoint=None, datasets: Optional[dict] = None) -> None:
        """Start ``fn`` on the ``train_loop`` thread. (JAX's takes the
        function cloudpickled; here the runtime ships it as an argument, so
        that in process it is never pickled.)"""
        session = _session_mod._process()
        sess = session._Session(context, checkpoint=checkpoint,
                                datasets=datasets, draining=self._draining)
        self._session = sess
        session._set_session(sess)
        card = _process()._card

        def _target():
            try:
                if card is not None:
                    torch.cuda.set_device(card)
                out = fn(config) if config is not None else fn()
                sess.finish(out)
            except session._StopTraining:
                sess.finish(None)
            except BaseException as e:  # noqa: BLE001 — reported to the driver
                sess.finish(None, error=traceback.format_exc(),
                            device_error=_is_device_error(e))

        t = threading.Thread(target=_target, daemon=True, name="train_loop")
        self._thread = t
        t.start()

    def poll(self, timeout: float = 10.0) -> Optional[dict]:
        if self._session is None:
            return {"type": "error", "error": "worker not started"}
        out = self._session.next_result(timeout)
        if out is not None and out["type"] in ("done", "error"):
            _session_mod._process()._set_session(None)
        return out

    def interrupt(self) -> None:
        if self._session is not None:
            self._session.stop()

    def stop_run(self, timeout: float = 30.0) -> bool:
        """Stop the loop and wait up to ``timeout`` s for its thread to end,
        taking what it reports meanwhile so that no ``report`` blocks; then
        free what the run held. -> whether the thread ended. (An actor's
        process ends with ``kill``; a gang of one in this process ends
        here, so the next attempt starts without this one's state.)"""
        sess, thread = self._session, self._thread
        if sess is None or thread is None:
            return True
        sess.stop()
        deadline = time.monotonic() + timeout
        while thread.is_alive() and time.monotonic() < deadline:
            sess.next_result(0.05)
        ended = not thread.is_alive()
        session = _session_mod._process()
        if session._get_session() is sess:
            session._set_session(None)
        self._session = self._thread = None
        del sess, thread
        gc.collect()
        return ended

    def request_save(self) -> None:
        """Driver-side save-on-preempt push: the next report should carry
        a checkpoint (session.should_checkpoint() flips true)."""
        if self._session is not None:
            self._session.request_save()

    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary fn inline on the worker (setup/teardown path)."""
        return fn(*args, **kwargs)


def _accelerator(runtime) -> str:
    """The runtime's name for an accelerator slot (module doc)."""
    have = runtime.cluster_resources()
    for name in _ACCELERATOR_NAMES:
        if have.get(name):
            return name
    raise ValueError(f"use_gpu=True: the runtime's cluster has no "
                     f"accelerator slot ({' or '.join(_ACCELERATOR_NAMES)}) "
                     f"among its resources {sorted(have)}")


class WorkerGroup:
    """``num_workers`` TrainWorkers behind ``runtime`` (module doc)."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK",
                 max_concurrency: int = 4, runtime=None):
        if runtime is None and num_workers > 1:
            raise ValueError(
                f"num_workers={num_workers} needs a runtime to host the "
                "gang: hand one in (runtime=ray_tpu, after ray_tpu.init()); "
                "without one the gang is this process alone (num_workers=1)")
        rt = local_runtime if runtime is None else runtime
        self.runtime = rt
        self.num_workers = num_workers
        res = dict(resources_per_worker)
        gpus = res.pop("GPU", 0.0)
        bundle = dict(res)
        make_pg = runtime_attr(rt, "util.placement_group")
        self._pg = None
        if make_pg is not None:
            if gpus:
                bundle[_accelerator(rt)] = gpus
            self._pg = make_pg([dict(bundle) for _ in range(num_workers)],
                               strategy=placement_strategy)
            if not self._pg.wait(120.0):
                self._remove_pg()
                raise TimeoutError(
                    f"placement group for {num_workers} train workers "
                    f"({bundle} each) not placeable")
        strategy = runtime_attr(rt, "util.PlacementGroupSchedulingStrategy")
        draining = runtime_attr(rt, "_private.worker_api.local_node_draining")
        cls = rt.remote(TrainWorker)
        self.workers = []
        for i in range(num_workers):
            opts: Dict[str, Any] = dict(
                num_cpus=res.get("CPU", 1),
                resources={k: v for k, v in res.items() if k != "CPU"}
                or None,
                max_concurrency=max_concurrency)
            if gpus:
                opts["num_gpus"] = gpus
            if self._pg is not None:
                opts["scheduling_strategy"] = strategy(
                    placement_group=self._pg, placement_group_bundle_index=i)
            self.workers.append(cls.options(**opts).remote(draining))

    def execute(self, fn: Callable, *args, timeout: Optional[float] = 60,
                **kwargs) -> List[Any]:
        """Run fn(*args) on every worker, gather results (barrier)."""
        refs = [w.execute.remote(fn, *args, **kwargs) for w in self.workers]
        return self.runtime.get(refs, timeout=timeout)

    def node_infos(self) -> List[Dict[str, Any]]:
        return self.runtime.get([w.node_info.remote() for w in self.workers],
                                timeout=60)

    def _remove_pg(self):
        remove = runtime_attr(self.runtime, "util.remove_placement_group")
        if self._pg is not None and remove is not None:
            try:
                remove(self._pg)
            except Exception:  # noqa: BLE001 — best effort at teardown
                pass
        self._pg = None

    def shutdown(self):
        """Kill the workers. ``kill`` is a no-op in process, so there the
        loop is stopped and its run freed first, so that the next attempt
        starts without this one's state."""
        if self.runtime is local_runtime:
            for w in self.workers:
                w.stop_run.remote()
        for w in self.workers:
            try:
                self.runtime.kill(w)
            except Exception:  # noqa: BLE001
                pass
        self._remove_pg()
        self.workers = []
