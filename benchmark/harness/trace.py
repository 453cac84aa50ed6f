"""The traced stretch: ``torch.profiler`` over a few steps after the
window, read in memory (nothing is written to disk). Device activity
(kernels, copies, fills) of this rank's card, and the benchmark's own spans
on the host (``feed``, ``step``, ``optimizer``) over the stretch, on the
profiler's clock (ns since the epoch)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

@dataclass
class Profile:
    steps: int
    window: Tuple[int, int]                       # stretch start, end (ns)
    device_ops: List[Tuple[str, int, int]]        # (name, start ns, ns)
    spans: List[Tuple[str, int, int]]             # (name, start ns, end ns)
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The device's busy time as disjoint intervals inside the
        stretch."""
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(s + d, hi))
                     for _, s, d in self.device_ops)
        out: List[List[int]] = []
        for s, e in ivs:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def outside(self) -> int:
        """Device ops that do not lie inside the stretch: the two clocks of
        the timeline disagree where this is not 0."""
        lo, hi = self.window
        return sum(1 for _, s, d in self.device_ops if s < lo or s + d > hi)

    def op_seconds(self, match) -> float:
        """Device seconds of the ops whose name ``match`` accepts."""
        return sum(d for n, _, d in self.device_ops if match(n)) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for name, _, d in self.device_ops:
            by[name] = by.get(name, 0) + d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], d / 1e9] for name, d in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest idle stretches of the device, each named by the
        innermost host span open when it began."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            inner = [sp for sp in self.spans if sp[1] <= s < sp[2]]
            name = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner \
                else "between spans"
            out.append([name, (e - s) / 1e9])
        return out


def _ns(ev, what: str) -> int:
    if hasattr(ev, what + "_ns"):
        return int(getattr(ev, what + "_ns")())
    return int(getattr(ev, what + "_us")() * 1000)


def profile_steps(program, steps: int) -> Profile:
    """``steps`` steps of ``program`` with the profiler tracing the card
    alone (tracing the host's every operator would slow the host enough to
    starve the card), the benchmark's spans kept on the host clock of the
    same timeline; the card is synchronised before the stretch ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA if program.cuda else ProfilerActivity.CPU]
    program.sync()
    before = program.launches()
    with profile(activities=acts) as prof:
        program.spans = []
        start = time.time_ns()
        for _ in range(steps):
            program.run_step()
        program.sync()
        window = (start, time.time_ns())
        spans, program.spans = program.spans, None
    after = program.launches()
    ops = []
    dev = program.device.index or 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or ev.device_index() != dev:
            continue
        if hasattr(ev, "is_user_annotation") and ev.is_user_annotation():
            continue
        ops.append((ev.name(), _ns(ev, "start"), int(ev.duration_ns())
                    if hasattr(ev, "duration_ns")
                    else int(ev.duration_us() * 1000)))
    return Profile(steps, window, ops, spans,
                   {k: after[k] - before[k] for k in after})
