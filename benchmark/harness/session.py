"""One run of a cell, the sequence that ``run.py`` drives:

1. set-up: the program's state from the seed, its first three steps
   through the window's own feed and step (warm-up, and the steps the check
   follows: the first two or three, by the cell), with the readings of its
   state after the first and after the last step the check follows;
2. the window: as many steps as fill ``seconds`` at the warmed-up steps'
   pace (rank 0's count, on every rank), issued back to back, a device
   event after each, no synchronisation until the window closes;
3. with ``trace``, a profiled stretch of a few more steps;
4. the peak memory, then the program's state freed and the reference run
   over the same batches;
5. the metrics, each from its reader, and the check."""

from __future__ import annotations

import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, List, Optional

import torch

from harness import check
from harness.cell import Cell, reader
from harness.program import Program
from harness.reference import AdamWConfig, Readings, run_reference
from harness.trace import profile_steps
from harness.weights import token_pool

WARMUP_STEPS = 3       # before the window; the check follows the first
                       # ``cell.reference_steps`` of them
STRETCH_S = 2.0        # the profiled stretch: at least this long ...
STRETCH_STEPS = 2      # ... and at least this many steps


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


@dataclass
class Window:
    steps: int
    seconds: float
    step_s: List[float]
    feed_s: List[float]
    optimizer_s: List[float] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)


def measure(prog: Program, steps: int) -> Window:
    """``steps`` steps back to back, each followed by a device event; the
    window closes when the card has finished the last."""
    prog.sync()
    prog.optimizer_events.clear()
    start = prog.Event(enable_timing=True)
    events, feed_s, losses = [], [], []
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        metrics = prog.run_step(feed_s)
        ev = prog.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(metrics["loss"])
    prog.sync()
    wall = time.perf_counter() - t0
    marks = [start] + events
    step_s = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    opt_s = [a.elapsed_time(b) / 1e3 for a, b in prog.optimizer_events]
    return Window(len(events), wall, step_s, feed_s, opt_s,
                  [float(x) for x in losses])


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist, dist.get_world_size(), dist.get_rank()
    return None, 1, 0


def _reduce(value: float, op: str, device) -> float:
    """``value`` reduced over the ranks (``"max"`` or ``"mean"``); itself
    on one rank. Rank 0's ``value`` alone where ``op`` is ``"first"``."""
    dist, world, _ = _world()
    if dist is None:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    if op == "first":
        dist.broadcast(t, 0)
    else:
        dist.all_reduce(t, dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
    return float(t) / (world if op == "mean" else 1)


def global_batch(cell: Cell) -> int:
    t = cell.traffic
    return t["batch_per_rank"] * t["chips"]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             fault: Optional[Callable[[Program], None]] = None) -> dict:
    """The run's result (without ``device``), as the last line has it, and
    ``numbers``: the check's raw numbers; None on ranks other than 0.
    ``fault`` breaks the program after its set-up is built (the planted
    faults of the tests and of ``calibrate.py``)."""
    spec, t = cell.spec, cell.traffic
    _, world, rank = _world()
    if device == "cuda":
        device = f"cuda:{rank}"
    marks = [("start", time.time() - t_start)]
    pool = token_pool(seed, t["pool"], global_batch(cell), t["seq"],
                      spec.vocab)
    prog = Program(spec, t, pool, seed, device, trace)
    marks.append(("program", time.time() - t_start))
    if fault is not None:
        fault(prog)
    losses, readings_s, paced = [], 0.0, []
    checked = cell.reference_steps
    for i in range(WARMUP_STEPS):
        w0 = time.perf_counter()
        losses.append(prog.run_step()["loss"])
        prog.sync()
        r0 = time.perf_counter()
        if i > 0:
            paced.append(r0 - w0)
        if i == 0:
            grads = prog.grad_norms()
        if i == checked - 1:
            change = prog.change_norms()
        prog.sync()
        readings_s += time.perf_counter() - r0
        marks.append((f"step {i + 1}", time.time() - t_start - readings_s))
    per_step = min(paced)
    # Every rank takes the same number of steps: rank 0's count for the
    # window's seconds at the warmed-up steps' pace.
    steps = int(_reduce(max(1, round(seconds / per_step)), "first",
                        prog.device))
    window = measure(prog, steps)
    setup_s = time.time() - window.seconds - t_start - readings_s
    profile = None
    if trace:
        per_step = window.seconds / window.steps
        stretch = max(STRETCH_STEPS, math.ceil(STRETCH_S / per_step))
        profile = profile_steps(prog, int(_reduce(stretch, "first",
                                                  prog.device)))
        log(f"profiled stretch: {profile.steps} steps, "
            f"{profile.window_s:.3f} s, device busy {profile.busy_s():.3f} s, "
            f"{len(profile.device_ops)} device ops, {profile.outside()} "
            f"outside the stretch")
    peak = int(_reduce(prog.peak_bytes(), "max", prog.device))
    prog_readings = Readings([float(x) for x in losses[:checked]], grads,
                             change)
    prog.free()
    del prog

    ms = sorted(1e3 * x for x in window.step_s)
    log("set-up, seconds from the process's start: " + ", ".join(
        f"{name} {at:.2f}" for name, at in marks))
    log(f"window: {window.steps} steps in {window.seconds:.3f} s; step ms "
        f"min {ms[0]:.1f} median {statistics.median(ms):.1f} max "
        f"{ms[-1]:.1f}; set-up {setup_s:.2f} s (readings {readings_s:.2f} s "
        f"apart); peak {peak} bytes")
    tokens = [torch.from_numpy(pool[i]) for i in range(checked)]
    r0 = time.perf_counter()
    ref = run_reference(spec, seed, tokens, AdamWConfig(t["lr"]), device)
    log(f"reference: {time.perf_counter() - r0:.1f} s; losses "
        f"{ref.losses}, program's {prog_readings.losses}")
    numbers = check.compare(prog_readings, ref)
    numbers["nonfinite"] = float(sum(not math.isfinite(x)
                                     for x in window.losses))
    verdict = check.judge(numbers, cell.limits)

    busy = _reduce(profile.busy_s(), "mean", device) if trace else None
    if rank != 0:
        return None
    run = SimpleNamespace(cell=cell, spec=spec, traffic=t, chips=cell.chips,
                          tokens_per_step=global_batch(cell) * t["seq"],
                          window=window, setup_s=setup_s, peak_bytes=peak,
                          profile=profile)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": verdict["correct"], "attempted": window.steps,
           "failed": int(numbers["nonfinite"]), "metrics": metrics,
           "peak_bytes": peak, "numbers": numbers,
           "checks": verdict["checks"]}
    if profile is not None:
        out["busy_s"], out["window_s"] = busy, profile.window_s
        out["breakdown"] = {"device_ops": profile.top_ops(),
                            "idle_gaps": profile.idle_gaps()}
    return out


def _finite(x):
    """``x`` with every non-finite number as a string, so that the line
    stays JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def result_line(out: dict, device: dict) -> dict:
    """The last line of a run from ``run_cell``'s result and the device's
    description: the driver's keys in order, then the numbers compared,
    and each beside its limit (``checks``) last."""
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["numbers"] = out["numbers"]
    line["checks"] = out["checks"]
    return _finite(line)
