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
- ``kill`` is a no-op.

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

    def result(self):
        if self._error is not None:
            raise self._error
        return self._value


class _Method:
    __slots__ = ("_fn",)

    def __init__(self, fn):
        self._fn = fn

    def remote(self, *args, **kwargs) -> LocalRef:
        return LocalRef(self._fn, args, kwargs)


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
