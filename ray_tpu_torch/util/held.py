"""Private copies of values that a runtime hands back as store views.

``ray_tpu`` resolves a large object to a zero-copy view of object-store
memory, which stays pinned only while this process holds an ObjectRef to
the object. A compiled DAG's channel reader drops the ref it read as soon
as the read returns, and the writer lets the object go at its next write,
so the store may reuse the memory while the caller still reads the view
(ROADMAP R-11). ``held_result`` keeps every ObjectRef that the calling
thread deserializes while it resolves a result, copies the result, and
only then lets those refs go: the object stays pinned, and borrowed from
its owner, until the copy is done.

The refs are caught at the runtime's own hook for them: the
``deserialized_ref_factory`` of its serialization context, through which
the core worker registers every ref it deserializes. The hook is wrapped
once per context; a thread that is not resolving passes straight through.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Callable

_lock = threading.Lock()


class _RefKeeper:
    """The context's ref factory, and on a thread inside ``held_result``
    a list that each ref it makes is appended to."""

    keeps_refs = True

    def __init__(self, inner: Callable):
        self.inner = inner
        self.local = threading.local()

    def __call__(self, *args):
        ref = self.inner(*args)
        kept = getattr(self.local, "kept", None)
        if kept is not None:
            kept.append(ref)
        return ref


def _keeper(runtime):
    """The wrapped ref factory of ``runtime``'s serialization context for
    this process, or None where it has none (no core worker)."""
    from ray_tpu_torch.train.worker_group import required_attr
    ctx = required_attr(runtime, "_private.serialization.context_for_process",
                        "ray_tpu._private.serialization")()
    with _lock:
        factory = ctx.deserialized_ref_factory
        if factory is None:
            return None
        if not getattr(factory, "keeps_refs", False):
            factory = _RefKeeper(factory)
            ctx.deserialized_ref_factory = factory
    return factory


def held_result(runtime, resolve: Callable[[], Any]) -> Any:
    """A deep copy of ``resolve()``, made while every ObjectRef that this
    thread deserialized inside ``resolve()`` is still held."""
    keeper = _keeper(runtime)
    if keeper is None:
        return copy.deepcopy(resolve())
    outer = getattr(keeper.local, "kept", None)
    kept: list = []
    keeper.local.kept = kept
    try:
        return copy.deepcopy(resolve())
    finally:
        keeper.local.kept = outer
        if outer is not None:
            outer.extend(kept)
