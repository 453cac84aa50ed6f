"""The per-layer metrics that read the port's spans (``fwd_ms``, ``bwd_ms``,
``grad_reduce_ms``, ``update_ms``, ``host_step_ms``; ``comm_gib`` and
``comm_calls`` where ranks exchange data), on the CPU through a whole small
run of each cell, as ``test_bench_port_check`` runs them; that they read
nothing from a checkout without the port's recorder and raise on a broken
one; and, on the card (marker ``cuda``), that the spans are on the clock
of the profiler's device timeline."""

import json
import sys
import threading
import time
import types
from pathlib import Path
from types import SimpleNamespace

import pytest

from harness.cell import load_cell, reader
from test_bench_port_check import SEEDS, run, small

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
STEP = ("fwd_ms", "bwd_ms", "grad_reduce_ms", "update_ms", "host_step_ms")
COMM = ("comm_gib", "comm_calls")


def reckoned_comm(workload):
    """(bytes, calls) a step of rank 0's collectives at the small cell:
    FSDP2 gathers the root's weights once and each layer's twice (forward,
    and the backward's recompute) and reduce-scatters each unit's
    gradients once, all in fp32 and whole; the step sums the loss and the
    norm's sum of squares, 4 bytes each."""
    blocks = [sum(4 * _numel(s) for _, s in b)
              for b in small(workload).spec.blocks()]
    root, layers = blocks[0], blocks[1:]
    gathered = root + 2 * sum(layers)
    return gathered + sum(blocks) + 8, 1 + 2 * len(layers) + len(blocks) + 2


def _numel(shape):
    n = 1
    for x in shape:
        n *= x
    return n


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reports_the_span_metrics(workload, tmp_path):
    out = run(workload, SEEDS[2], trace=True, tmp_path=tmp_path)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(STEP) <= set(got), got
    assert all(got[k] > 0 for k in STEP), got
    # On the CPU a span's device time is its host time, and the four
    # phases lie inside the step.
    phases = sum(got[k] for k in STEP[:4])
    assert phases <= got["host_step_ms"], got
    if load_cell(ROOT, workload).chips > 1:
        nbytes, calls = reckoned_comm(workload)
        assert got["comm_calls"] == calls, got
        assert got["comm_gib"] * 2 ** 30 == pytest.approx(nbytes, rel=1e-12)
    else:
        assert not set(COMM) & set(got), got


@pytest.mark.parametrize("workload", CELLS)
def test_an_untraced_run_reports_none_of_them(workload, tmp_path):
    out = run(workload, SEEDS[2], trace=False, tmp_path=tmp_path)
    assert not set(STEP + COMM) & set(out["metrics"]), out["metrics"]


class _Span:
    """A recorded span as the readers see it: 1 ms, 1 GiB."""

    def __init__(self, name):
        self.name, self.host_ns = name, 10 ** 6
        self.counts = {"bytes": 2 ** 30}

    def device_ns(self):
        return 10 ** 6


def _recorder(names):
    mod = types.ModuleType("ray_tpu_torch.util.spans")
    mod.recorded = lambda lo, hi: [_Span(n) for n in names]
    return mod


RUN = SimpleNamespace(profile=SimpleNamespace(window=(0, 2 ** 63), steps=1))
SPANS = ("forward", "backward", "reduce", "grad_norm", "update", "step",
         "all_gather", "reduce_scatter", "all_reduce")


@pytest.mark.parametrize("metric", STEP + COMM)
def test_a_port_without_the_recorder_gives_nothing(metric, monkeypatch):
    monkeypatch.setitem(sys.modules, "ray_tpu_torch.util.spans",
                        _recorder(SPANS))
    assert reader(metric)(RUN) > 0
    monkeypatch.setitem(sys.modules, "ray_tpu_torch.util.spans", None)
    assert reader(metric)(RUN) is None


@pytest.mark.parametrize("metric", STEP + COMM)
def test_a_broken_recorder_raises(metric, monkeypatch):
    broken = types.ModuleType("ray_tpu_torch.util.spans")   # no recorded()
    monkeypatch.setitem(sys.modules, "ray_tpu_torch.util.spans", broken)
    with pytest.raises(ImportError):
        reader(metric)(RUN)


def _device_ops(prof, device):
    from torch.autograd import DeviceType
    from harness.trace import _ns
    ops = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or \
                ev.device_index() != device:
            continue
        if hasattr(ev, "is_user_annotation") and ev.is_user_annotation():
            continue
        ops.append((_ns(ev, "start"), ev.name()))
    return sorted(ops)


@pytest.mark.cuda
def test_spans_share_the_profilers_clock():
    """A kernel launched inside a span on an idle card starts on the
    profiler's device timeline after the span's host start, within 1 ms;
    a span opened on autograd's thread (a hook in a backward on the card,
    where FSDP2's reduce-scatters are issued) is recorded too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from ray_tpu_torch.util.spans import recorded, span
    x = torch.randn(2048, 2048, device="cuda", requires_grad=True)
    (x @ x).sum().backward()
    torch.cuda.synchronize()

    threads = []

    def hook(g):
        threads.append(threading.get_ident())
        with span("hook"):
            return g * 1.0

    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.cuda.synchronize()
            time.sleep(0.01)
            with span("probe"):
                y = x @ x
            torch.cuda.synchronize()
        y = x @ x
        y.register_hook(hook)
        y.sum().backward()
        torch.cuda.synchronize()
    probes = [s for s in recorded(t0) if s.name == "probe"]
    assert len(probes) == 5
    ops = _device_ops(prof, torch.cuda.current_device())
    offsets = []
    # The card is idle for 10 ms before each probe: its kernel is the first
    # op after the previous probe's end (a clock 10 ms off or more shows).
    for i, s in enumerate(probes):
        lo = probes[i - 1].end_ns if i else t0
        hi = probes[i + 1].start_ns if i + 1 < len(probes) else float("inf")
        mine = [t for t, _ in ops if lo <= t < hi]
        assert mine, (s, ops[:5])
        offsets.append(mine[0] - s.start_ns)
        assert s.device_ns() > 0
    print(f"kernel start - span host start, ns: {offsets}")
    assert all(0 <= d <= 10 ** 6 for d in offsets), offsets
    assert [s.name for s in recorded(t0) if s.name == "hook"] == ["hook"]
    assert threads != [threading.get_ident()]     # autograd's own thread
