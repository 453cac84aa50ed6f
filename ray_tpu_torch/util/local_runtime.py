"""The in-process runtime: the port's stand-in for ``ray_tpu`` when an
``Algorithm`` is built, or a ``Trainer`` fits, without one.

JAX's ``Algorithm`` drives its runners, and its Train harness its workers,
through four calls of the actor runtime: ``remote`` (make a class an actor
class), ``get``, ``wait`` and ``kill``. The port's ``Algorithm`` and
``Trainer`` take those calls from a runtime object that the caller may
hand in (``build(runtime=ray_tpu)``, ``Trainer(..., runtime=ray_tpu)``:
the runners or train workers are then ``ray_tpu`` actors, exactly as in
JAX). This module is that surface in one process:

- ``remote(cls).remote(*args)`` builds the object here and returns a
  handle; ``handle.method.remote(*args)`` runs the call at once, in
  submission order, as an actor's mailbox would, and returns a finished
  ref (an exception is kept and raised by ``get``);
- ``get`` unwraps refs;
- ``wait(refs, num_returns)`` returns the first ``num_returns`` refs in
  submission order;
- ``kill`` is a no-op;
- ``dag.InputNode`` and ``dag.compiled.CompiledDAG`` (the attribute paths of
  ``ray_tpu.dag``): ``handle.method.bind(node, ...)`` chains member calls
  onto an input, and ``CompiledDAG.compile(root).execute_async(value)``
  runs the whole chain at once and returns a finished ref, with
  ``stats()`` and ``teardown()``. That is a compiled DAG of depth 1: no
  tick is ever in flight behind another, and none is replayed.

Running each call at submission keeps the order an actor would see: a
re-dispatched ``sample`` (IMPALA, APPO) runs with the weights the runner
held when it was queued, because the ``set_weights`` that follows it is
submitted later. A train worker's ``start_run`` starts the loop on its own
thread and returns, and each ``poll`` waits on the loop's report queue in
the caller's thread, so a gang of one trains here as a ``ray_tpu`` actor
would. No feature is added: the runners and workers still live behind a
runtime, and this one runs them in the caller's process, where they share
its device.
"""

from __future__ import annotations

import itertools
import types
from typing import Any, List, Optional, Sequence, Tuple

_order = itertools.count()


class LocalRef:
    """A finished call: its value or its exception, and its place in the
    submission order."""

    __slots__ = ("_value", "_error", "seq")

    def __init__(self, fn, args, kwargs):
        self.seq = next(_order)
        self._value = self._error = None
        try:
            self._value = fn(*args, **kwargs)
        except Exception as e:  # raised by get, as an actor's error is
            self._error = e

    def result(self, timeout: Optional[float] = None):
        if self._error is not None:
            raise self._error
        return self._value


class _Method:
    __slots__ = ("_fn",)

    def __init__(self, fn):
        self._fn = fn

    def remote(self, *args, **kwargs) -> LocalRef:
        return LocalRef(self._fn, args, kwargs)

    def bind(self, *args) -> "_Bound":
        return _Bound(self._fn, args)


class LocalActor:
    """A handle on an object of this process: ``handle.m.remote(...)``."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        if name.startswith("__"):      # copy/pickle probes, not methods
            raise AttributeError(name)
        return _Method(getattr(self._obj, name))


class _LocalClass:
    def __init__(self, cls):
        self._cls = cls

    def remote(self, *args, **kwargs) -> LocalActor:
        return LocalActor(self._cls(*args, **kwargs))

    def options(self, **_opts) -> "_LocalClass":
        return self


def remote(*args, **_opts):
    """``remote(cls)`` or ``remote(num_cpus=...)(cls)``: resource options
    mean nothing in one process and are accepted as ``ray_tpu`` takes
    them."""
    if len(args) == 1 and callable(args[0]) and not _opts:
        return _LocalClass(args[0])
    return _LocalClass


def get(refs, timeout: Optional[float] = None):
    if isinstance(refs, LocalRef):
        return refs.result()
    return [r.result() for r in refs]


def wait(refs: Sequence[LocalRef], num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[LocalRef], List[LocalRef]]:
    ordered = sorted(refs, key=lambda r: r.seq)
    return ordered[:num_returns], ordered[num_returns:]


def kill(_actor: Any) -> None:
    pass


class InputNode:
    """The input of a chain of bound calls: ``with InputNode() as inp:``."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> bool:
        return False


class _Bound:
    """A member call bound to its arguments: bound calls, the input, or
    values."""

    __slots__ = ("fn", "args")

    def __init__(self, fn, args):
        self.fn, self.args = fn, args


class CompiledDAG:
    """A chain of bound calls run in this process (module doc): each
    ``execute_async`` runs every call of the chain, arguments first in
    order, each call once, and returns a finished ``LocalRef``."""

    def __init__(self, root: _Bound):
        self._root = root
        self._next_seq = 0
        self.ticks = 0
        self._state = "local"

    @classmethod
    def compile(cls, root: _Bound, **_options) -> "CompiledDAG":
        """Channel and recovery options mean nothing in one process and are
        accepted as ``ray_tpu``'s ``CompiledDAG.compile`` takes them."""
        return cls(root)

    def execute_async(self, value) -> LocalRef:
        if self._state == "torn_down":
            raise RuntimeError("the DAG is torn down")
        self._next_seq += 1
        ref = LocalRef(self._run, (value,), {})
        if ref._error is None:
            self.ticks += 1
        return ref

    def _run(self, value):
        done = {}

        def ev(node):
            if isinstance(node, InputNode):
                return value
            if not isinstance(node, _Bound):
                return node
            if id(node) not in done:
                done[id(node)] = node.fn(*[ev(a) for a in node.args])
            return done[id(node)]

        return ev(self._root)

    def stats(self) -> dict:
        return {"ticks": self.ticks, "inflight": 0,
                "max_inflight": min(self.ticks, 1), "state": self._state,
                "tick_replay": False, "recoveries": 0, "replayed_ticks": 0}

    def teardown(self) -> None:
        self._state = "torn_down"


# The attribute paths of ray_tpu.dag that the port's DAG users read.
dag = types.SimpleNamespace(
    InputNode=InputNode,
    compiled=types.SimpleNamespace(CompiledDAG=CompiledDAG))
