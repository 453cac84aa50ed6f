"""The system under test: ``ray_tpu_torch``'s train step, driven through its
own entry points (``build_mesh`` -> ``init_train_state`` ->
``make_train_step``, batches through ``device_batch_stream``), and the
readings of its state that the check compares. The benchmark takes from the
program only these entry points, the model and loss that the
architecture's ``archs/<arch>/program.py`` names, its parameters and
optimizer state as the step leaves them, and its kernels' launch
counters.

What ``Program`` calls of an architecture's ``program.py``:

- ``model(spec, traffic, device)``: the port's model for the spec at the
  traffic's sequence, type and remat policy, whose parameters are the
  spec's leaves by name and shape; the seed's weights are copied into it;
- ``loss_fn(spec, traffic)``: the loss function ``make_train_step`` takes;
- ``launches()`` (optional): further launch counters of the port, {name:
  count}, reported beside K1-K3's."""

from __future__ import annotations

import itertools
import math
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import arch
from harness.weights import block_weights


class HostEvent:
    """``torch.cuda.Event``'s surface on the host clock, for runs on the
    CPU (the tests); never used on the card."""

    def __init__(self, enable_timing: bool = True):
        self.t = None

    def record(self, stream=None) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "HostEvent") -> float:
        return 1e3 * (end.t - self.t)


class Program:
    """One rank's training state and step at ``cell``'s configuration and
    traffic, weights from ``seed``, batches cycled from ``pool`` ([n,
    global batch, seq + 1] token ids). ``trace``: device events around each
    update; spans around the feed, the step and the optimizer while
    ``spans`` is a list."""

    def __init__(self, spec, traffic: dict, pool: np.ndarray, seed: int,
                 device: str = "cuda", trace: bool = False):
        from ray_tpu_torch.data.feed import device_batch_stream
        from ray_tpu_torch.parallel import MeshConfig, build_mesh
        from ray_tpu_torch.train.train_step import (AdamW, init_train_state,
                                                    make_train_step)

        self.spec, self.traffic, self.seed = spec, traffic, seed
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.Event = torch.cuda.Event if self.cuda else HostEvent
        self.trace = trace       # device events around each update
        self.arch = arch.module(spec, "program")
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
        devices = None if self.cuda else ["cpu"] * world
        self.mesh = build_mesh(MeshConfig(**traffic["mesh"]), devices=devices)
        strategy = traffic["strategy"]
        program = self

        class TimedAdamW(AdamW):
            """The program's AdamW, with a span and a pair of device events
            around each update."""

            def update(self, grads, state, params):
                if not program.trace:
                    return super().update(grads, state, params)
                start, end = program.Event(enable_timing=True), \
                    program.Event(enable_timing=True)
                with program.span("optimizer"):
                    start.record()
                    out = super().update(grads, state, params)
                    end.record()
                program.optimizer_events.append((start, end))
                return out

        self.optimizer_events: List[tuple] = []
        self.spans: Optional[list] = None
        self.opt = TimedAdamW(traffic["lr"])
        self.state = init_train_state(self._init, self.opt, self.mesh,
                                      strategy)
        self.model = self.state.params
        self.step_fn = make_train_step(self.arch.loss_fn(spec, traffic),
                                       self.opt, self.mesh, strategy)
        batches = ({"tokens": pool[i]} for i in itertools.cycle(
            range(pool.shape[0])))
        self.feed = device_batch_stream(batches, self.mesh, strategy,
                                        device=None if self.cuda else "cpu")

    def _init(self):
        """init_fn of ``init_train_state``: the architecture's model with
        the benchmark's weights, copied in by name, one block at a time."""
        model = self.arch.model(self.spec, self.traffic, self.device)
        params = dict(model.named_parameters())
        want = {n: tuple(s) for b in self.spec.blocks() for n, s in b}
        have = {n: tuple(p.shape) for n, p in params.items()}
        if have != want:
            raise ValueError(
                "the model's parameters are not the spec's leaves: "
                f"{sorted(set(have.items()) ^ set(want.items()))[:8]}")
        with torch.no_grad():
            for b in range(len(self.spec.blocks())):
                for name, w in block_weights(self.spec, self.seed, b,
                                             self.device).items():
                    params[name].copy_(w)
        return model

    @contextmanager
    def _span(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, start, time.time_ns()))

    def span(self, name: str):
        """A host span on the clock of the profiler's timeline (ns since the
        epoch), kept while ``spans`` is a list (the profiled stretch)."""
        return nullcontext() if self.spans is None else self._span(name)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def run_step(self, feed_times: Optional[list] = None) -> dict:
        """One step: the next batch from the feed, then the train step.
        ``feed_times`` gets the host seconds spent in the feed."""
        t = time.perf_counter()
        with self.span("feed"):
            batch = next(self.feed)
        if feed_times is not None:
            feed_times.append(time.perf_counter() - t)
        with self.span("step"):
            self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    # ---- readings for the check -------------------------------------------

    def _sum_over_shards(self, p, sq: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(p, DTensor):
            import torch.distributed as dist
            dist.all_reduce(sq)
        return sq

    def grad_norms(self) -> Dict[str, float]:
        """Each leaf's gradient norm as the optimizer got it at the first
        step, from AdamW's first moment after it (mu = (1 - b1) g)."""
        if self.state.opt_state.count != 1:
            raise RuntimeError("the first moment is the gradient only after "
                               "the first step")
        out = {}
        for (name, p), mu in zip(self.model.named_parameters(),
                                 self.state.opt_state.mu):
            sq = self._sum_over_shards(p, torch.sum(mu.double() ** 2))
            out[name] = math.sqrt(float(sq)) / (1.0 - self.opt.b1)
        return out

    def change_norms(self) -> Dict[str, float]:
        """Each leaf's ‖θ - θ0‖, θ0 drawn again from the seed."""
        whole = {name: p.full_tensor() if hasattr(p, "full_tensor") else p
                 for name, p in self.model.named_parameters()}
        out = {}
        with torch.no_grad():
            for b in range(len(self.spec.blocks())):
                for name, w0 in block_weights(self.spec, self.seed, b,
                                              self.device).items():
                    out[name] = float(torch.linalg.vector_norm(
                        (whole[name].detach() - w0).double()))
        return out

    def launches(self) -> Dict[str, int]:
        """K1-K3's launch counters, and the architecture's own."""
        from ray_tpu_torch.ops.attention import KERNELS
        out = {k: kern.launches for k, kern in KERNELS.items()}
        more = getattr(self.arch, "launches", None)
        return {**out, **more()} if more else out

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda \
            else 0

    def free(self) -> None:
        """Drop the program's state and return its memory to the card."""
        self.state = self.model = self.step_fn = self.feed = None
        import gc
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
