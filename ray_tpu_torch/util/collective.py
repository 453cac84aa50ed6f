"""Host-plane collectives: the counterpart of ``ray_tpu/util/collective.py``.

The JAX module keeps a named rendezvous actor whose mailboxes carry numpy
payloads through the object store. The port keeps its API over
``torch.distributed`` process groups instead, the original Ray's own
backends: gloo for host tensors, NCCL for CUDA ones. ``init_collective_group``
joins a named group of the whole world; it initialises the world's default
process group first where no one has (give it ``init_method``, for example
``tcp://localhost:<port>`` or ``file://<path>``).

Every function takes a numpy array, a torch tensor, a number, or a tree of
dicts, lists and tuples of those (``allreduce``, ``reduce``), and returns
the same kind: numpy in, numpy out; a tensor comes back on its own device.
On an NCCL group the payload travels through the current CUDA device. As
in the reference:

- ``reduce`` returns the result on ``dst_rank`` and the input elsewhere;
- ``broadcast`` takes None on every rank but ``src_rank``;
- ``allgather`` returns the list of every rank's value, shapes may differ;
- ``reducescatter`` takes one array and returns this rank's part of the
  reduced array, split along dim 0 as ``np.array_split`` splits it (the
  parts may be uneven, which ``reduce_scatter_tensor`` does not allow: the
  parts are padded to the longest for it);
- ``send`` returns without waiting for the receiver, so two ranks may send
  to each other before they receive; ``recv`` takes what the peer's next
  send to it sent, of any shape (a header of its shape and type travels
  first). Point to point goes over a gloo group of its own in host
  memory whatever the backend, as the reference's host plane ships numpy.
  This is a workaround, not a property of NCCL that was shown: on four
  H100s the symmetric exchange over NCCL hung in three designs (``send``
  and ``recv`` on the collective group; a group per direction;
  ``batch_isend_irecv`` after making each pair's communicator), while the
  pipeline's blocking NCCL P2P on the same cards does not hang. The cause
  was not isolated; PERF.md, section 6, lists the runs.

All ranks must call the same collectives in the same order. The rendezvous
actor itself is runtime and is not ported.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
        ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
        ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX}

# A message's header on the wire: dtype code, number of dims, then up to
# _MAX_DIMS sizes.
_MAX_DIMS = 8
_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool]


@dataclass
class _GroupState:
    world_size: int
    rank: int
    group: Any
    p2p: Any           # gloo: send and recv
    device: torch.device
    pending: List[Any] = field(default_factory=list)   # sends in flight


_groups: Dict[str, _GroupState] = {}
_groups_lock = threading.Lock()


def init_collective_group(world_size: int, rank: int,
                          backend: str = "gloo",
                          group_name: str = "default",
                          init_method: Optional[str] = None) -> None:
    """Join a collective group of the whole world (call once on each
    member). ``backend``: "gloo" (host tensors) or "nccl" (CUDA tensors,
    on the current device)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
    with _groups_lock:
        if group_name in _groups:
            raise RuntimeError(
                f"group '{group_name}' already initialized here")
    if not dist.is_initialized():
        if init_method is None:
            raise ValueError("no process group yet: give init_method (the "
                             "world's address, e.g. tcp://localhost:<port>)")
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
        raise ValueError(f"rank {rank} of {world_size}: the world is rank "
                         f"{dist.get_rank()} of {dist.get_world_size()}")
    group = dist.new_group(backend=backend)
    p2p = dist.new_group(backend="gloo")
    device = (torch.device("cuda", torch.cuda.current_device())
              if backend == "nccl" else torch.device("cpu"))
    with _groups_lock:
        _groups[group_name] = _GroupState(world_size, rank, group, p2p,
                                          device)


def destroy_collective_group(group_name: str = "default") -> None:
    with _groups_lock:
        state = _groups.pop(group_name, None)
    if state is not None:
        _flush(state)
        for group in (state.group, state.p2p):
            dist.destroy_process_group(group)


def _group(group_name: str) -> _GroupState:
    with _groups_lock:
        g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group '{group_name}' not initialized; call "
            f"init_collective_group() first")
    return g


def _flush(g: _GroupState) -> None:
    """Wait for this rank's sends in flight."""
    for work in g.pending:
        work.wait()
    g.pending.clear()


# ---------------------------------------------------------------------------
# Values: numpy, tensors, numbers, and trees of them
# ---------------------------------------------------------------------------

def _to_tensor(x, g: _GroupState) -> torch.Tensor:
    """A copy of ``x`` on the group's device (the collectives work in
    place; the caller's value stays as it was)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.detach().to(g.device, copy=True).contiguous()


def _like(t: torch.Tensor, x):
    """``t`` as the kind of value ``x`` was."""
    if isinstance(x, torch.Tensor):
        return t.to(x.device)
    out = t.cpu().numpy()
    return out if isinstance(x, np.ndarray) else out[()]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for sub in tree for v in _leaves(sub)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in ``_leaves``'s order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)
    return build(tree)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def allreduce(tensor, group_name: str = "default", op: str = ReduceOp.SUM):
    """Allreduce an array or a tree of them across the group; returns the
    result."""
    g = _group(group_name)
    leaves = _leaves(tensor)
    out = []
    for x in leaves:
        t = _to_tensor(x, g)
        dist.all_reduce(t, op=_OPS[op], group=g.group)
        out.append(_like(t, x))
    return _rebuild(tensor, out)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = ReduceOp.SUM):
    g = _group(group_name)
    leaves = _leaves(tensor)
    out = []
    for x in leaves:
        t = _to_tensor(x, g)
        dist.reduce(t, dist.get_global_rank(g.group, dst_rank),
                    op=_OPS[op], group=g.group)
        out.append(_like(t, x))
    return _rebuild(tensor, out) if g.rank == dst_rank else tensor


def _header(t: Optional[torch.Tensor], g: Optional[_GroupState]
            ) -> torch.Tensor:
    """[dtype code, ndim, sizes...]; -1 where there is no tensor. On the
    group's device (None: the host)."""
    h = torch.full((2 + _MAX_DIMS,), -1, dtype=torch.int64)
    if t is not None:
        if t.dim() > _MAX_DIMS:
            raise ValueError(f"{t.dim()} dims; at most {_MAX_DIMS}")
        h[0], h[1] = _DTYPES.index(t.dtype), t.dim()
        h[2:2 + t.dim()] = torch.tensor(t.shape)
    return h if g is None else h.to(g.device)


def _from_header(h: torch.Tensor, g: Optional[_GroupState]) -> torch.Tensor:
    h = h.cpu().tolist()
    return torch.empty(h[2:2 + h[1]], dtype=_DTYPES[h[0]],
                       device="cpu" if g is None else g.device)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """``src_rank``'s value on every rank; the others may pass None."""
    g = _group(group_name)
    src = dist.get_global_rank(g.group, src_rank)
    mine = g.rank == src_rank
    t = _to_tensor(tensor, g) if mine else None
    h = _header(t, g)
    dist.broadcast(h, src, group=g.group)
    if not mine:
        t = _from_header(h, g)
    dist.broadcast(t, src, group=g.group)
    if tensor is None:
        return t.cpu().numpy()
    return _like(t, tensor)


def allgather(tensor, group_name: str = "default") -> List:
    """Every rank's value, in rank order; their shapes may differ."""
    g = _group(group_name)
    t = _to_tensor(tensor, g)
    heads = [torch.empty_like(_header(t, g)) for _ in range(g.world_size)]
    dist.all_gather(heads, _header(t, g), group=g.group)
    shapes = [_from_header(h, g) for h in heads]
    longest = max(s.numel() for s in shapes)
    flat = torch.zeros(longest, dtype=t.dtype, device=g.device)
    flat[:t.numel()] = t.reshape(-1)
    parts = [torch.empty_like(flat) for _ in range(g.world_size)]
    dist.all_gather(parts, flat, group=g.group)
    return [_like(p[:s.numel()].reshape(s.shape), tensor)
            for p, s in zip(parts, shapes)]


def reducescatter(tensor, group_name: str = "default",
                  op: str = ReduceOp.SUM):
    """This rank's part of the reduced array, split along dim 0 as
    ``np.array_split`` splits it."""
    # Validate locally before any rank posts its part.
    if not isinstance(tensor, (np.ndarray, torch.Tensor)):
        raise TypeError(
            "reducescatter takes a single ndarray (partitioned along "
            "axis 0); reduce pytrees with allreduce instead")
    g = _group(group_name)
    t = _to_tensor(tensor, g)
    n, w = t.shape[0], g.world_size
    sizes = [len(p) for p in np.array_split(np.arange(n), w)]
    longest = max(sizes)
    padded = torch.zeros((w, longest) + tuple(t.shape[1:]), dtype=t.dtype,
                         device=g.device)
    start = 0
    for r, size in enumerate(sizes):
        padded[r, :size] = t[start:start + size]
        start += size
    out = torch.empty((longest,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=g.device)
    dist.reduce_scatter_tensor(out, padded.reshape((w * longest,)
                                                   + tuple(t.shape[1:])),
                               op=_OPS[op], group=g.group)
    return _like(out[:sizes[g.rank]], tensor)


def barrier(group_name: str = "default") -> None:
    g = _group(group_name)
    _flush(g)
    dist.barrier(group=g.group)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Post ``tensor`` to ``dst_rank``; returns without waiting for it to be
    received."""
    g = _group(group_name)
    t = _to_tensor(tensor, g).cpu()
    dst = dist.get_global_rank(g.p2p, dst_rank)
    g.pending.append(dist.isend(_header(t, None), dst, group=g.p2p))
    g.pending.append(dist.isend(t, dst, group=g.p2p))


def recv(src_rank: int, group_name: str = "default"):
    """What ``src_rank``'s next send to this rank sent (numpy)."""
    g = _group(group_name)
    src = dist.get_global_rank(g.p2p, src_rank)
    h = _header(None, None)
    dist.recv(h, src, group=g.p2p)
    t = _from_header(h, None)
    dist.recv(t, src, group=g.p2p)
    return t.numpy()
