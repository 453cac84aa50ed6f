"""Spans of the train step, on the clock of ``torch.profiler``'s timeline.

``span(name, step=None, tensor=None)`` marks a stretch of the program: its
name, its host start and end as ``time.time_ns()`` (ns since the epoch,
the clock the profiler's events are on), the span that encloses it, the
train step it belongs to, its counts (``bytes``: the size of a
collective's ``tensor``) and, in a process that has initialised CUDA, a
pair of timing events recorded on the current stream at its start and end.
``recorded()`` returns the finished spans.

A span records only while ``torch.profiler`` is active on its thread (the
autograd engine's threads, where FSDP2's post-backward hooks run, carry the
caller's profiler state): an operator turns the spans on by profiling,
which they do anyway to see the card. Otherwise a span costs that one check
and records nothing; a collective's bytes are reckoned only when it
records. The last ``CAPACITY`` spans are kept in memory; the port writes
none of them anywhere.

The spans of the port: ``step`` (``train_step.make_train_step``'s step,
``step=`` its number), inside it ``forward`` and ``backward`` (none inside
a loss that runs its own backward), ``reduce``, ``grad_norm`` and
``update``; ``all_reduce`` (the step's own sums) and FSDP2's
``all_gather`` and ``reduce_scatter``, each with ``bytes`` of its
unsharded side. Inside a layer of the DeepSeek-V3 block
(``models/gpt.py``), in the forward and in remat's recompute alike:
``mla``, the latent attention block, and ``experts``, the sparse expert
layer (routing, dispatch, the held and shared experts, the combine), whose
passes and rows computed on held experts the counters
``models.gpt.EXPERTS.calls`` and ``.rows`` count. Each is read by a
per-layer metric of the benchmark."""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import _profiler_enabled

CAPACITY = 65536

_NOTHING = contextlib.nullcontext()


class Span:
    """One recorded span. ``end_ns`` is None while it is open."""

    __slots__ = ("id", "name", "parent", "step", "start_ns", "end_ns",
                 "counts", "events")

    def __init__(self, id: int, name: str, parent: Optional[int],
                 step: Optional[int], counts: Dict[str, int], events):
        self.id, self.name, self.parent, self.step = id, name, parent, step
        self.counts = counts
        self.events: Optional[Tuple] = events
        self.start_ns = time.time_ns()
        self.end_ns: Optional[int] = None

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns

    def device_ns(self) -> int:
        """The device's time from the span's start to its end on the stream
        it was issued to; the host's where no events were recorded (the CPU
        runs each op as it is issued). Synchronise with the device first."""
        if self.events is None:
            return self.host_ns
        start, end = self.events
        return round(start.elapsed_time(end) * 1e6)


_spans: collections.deque = collections.deque(maxlen=CAPACITY)
_open: List[Span] = []   # open spans of every thread, in the order opened
_ids = itertools.count()


@contextlib.contextmanager
def _record(name: str, step: Optional[int],
            tensor: Optional[torch.Tensor]):
    # The innermost open span encloses this one, whichever thread opened it:
    # autograd's thread runs the reduce-scatters while the caller waits in
    # ``backward``.
    parent = _open[-1] if _open else None
    if step is None and parent is not None:
        step = parent.step
    events = None
    if torch.cuda.is_initialized():
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    counts = {} if tensor is None else {
        "bytes": tensor.numel() * tensor.element_size()}
    rec = Span(next(_ids), name, None if parent is None else parent.id,
               step, counts, events)
    _spans.append(rec)
    _open.append(rec)
    if events is not None:
        events[0].record()
    try:
        yield rec
    finally:
        if events is not None:
            events[1].record()
        rec.end_ns = time.time_ns()
        _open.remove(rec)


def span(name: str, step: Optional[int] = None,
         tensor: Optional[torch.Tensor] = None):
    """A context manager that records the stretch it encloses as a span
    ``name`` while the profiler is active. ``step``: the train step's
    number, which the spans inside it take too. ``tensor``: a collective's
    buffer, whose size the span counts as ``bytes``."""
    if not _profiler_enabled():
        return _NOTHING
    return _record(name, step, tensor)


def recorded(start_ns: Optional[int] = None,
             end_ns: Optional[int] = None) -> List[Span]:
    """The finished spans kept, in the order they started; with
    ``start_ns``/``end_ns``, those whose host start lies between them."""
    lo = -1 if start_ns is None else start_ns
    hi = float("inf") if end_ns is None else end_ns
    return [s for s in list(_spans)
            if s.end_ns is not None and lo <= s.start_ns <= hi]
