"""Host-plane collectives: the counterpart of ``ray_tpu/util/collective.py``.

The JAX module keeps one named rendezvous actor per group, whose mailboxes
carry numpy payloads through the object store. The port keeps its API over
``torch.distributed`` process groups instead, the original Ray's own
backends: gloo for host tensors, NCCL for CUDA ones. As in the reference,
each named group is a rendezvous of its own: ``init_collective_group``
makes the group's process groups from a store for that group alone (read
under the group's name), whatever the process's default world is, so one
process may sit in several groups, each with its own size and its own rank
for that process, and a group may hold some processes of a world and not
others.

Where the store comes from (``init_method``):

- ``tcp://host:port``: a ``TCPStore`` that the group's rank 0 serves. Rank 0
  opens it with ``open_collective_store`` before it joins (the port the
  bind picks, so no other process can take it first) and hands the address
  it returns to the other members;
- None: a group of one keeps a store of its own; otherwise the group meets
  in the store of the process's default world (``init_process_group``),
  which every member then shares. That store outlives the group, so each
  forming of a name meets under a number of its own, which rank 0 draws
  from the store and posts to each other member (``_world_store``): a name
  formed again, by the same members or others, meets afresh.

``create_collective_group`` does this over actors: it asks rank 0's actor
to open the store, then every member to join with the address. The
runtime is handed in, as ``build(runtime=...)`` and ``Trainer(runtime=...)``
take it (``runtime=ray_tpu``: actors in processes of their own; None:
``util/local_runtime.py``, in the caller's process). ``ray_tpu`` ships the
port's modules by value, so this module's state lives in the module as the
process imported it (``_process()``) and the mixin's methods call through
it.

Every function takes a numpy array, a torch tensor, a number, or a tree of
dicts, lists and tuples of those (``allreduce``, ``reduce``, ``broadcast``),
and returns the same kind: numpy in, numpy out; a tensor the caller passed
comes back on its own device, one that arrives from another member on the
group's device. On an NCCL group the payload travels through the current
CUDA device, the one bound when the group was made. As in the reference:

- ``reduce`` returns the result on ``dst_rank`` and the input elsewhere;
- ``broadcast`` takes None on every rank but ``src_rank`` and returns what
  ``src_rank`` passed (a tree travels as one buffer per dtype);
- ``allgather`` returns the list of every rank's value, shapes may differ;
- ``reducescatter`` takes one array and returns this rank's part of the
  reduced array, split along dim 0 as ``np.array_split`` splits it (the
  parts may be uneven, which ``reduce_scatter_tensor`` does not allow: the
  parts are padded to the longest for it);
- ``send`` returns without waiting for the receiver, so two ranks may send
  to each other before they receive; ``recv`` takes what the peer's next
  send to it sent, of any shape (a header of its shape, type and kind
  travels first). A send to this rank itself waits in the group's mailbox
  for this rank's ``recv``. Point to point goes over the host, as the
  reference's mailboxes do: a gloo process group of the two members for
  each direction between them (a link), on an NCCL group too, whose
  tensors cross to the host and back. A link is made at its first use, by
  both its ends (``_link``), each over a store connection of its own: the
  sender's end on a thread that then sends this rank's messages to that
  peer in order (``_Sender``), so that ``send`` returns at once even while
  the link waits for the peer; the receiver's end in its first ``recv``.
  A group that never sends makes none. NCCL pairs were dearer and
  hazardous: made with the group, the six a rank at world 4 took most of
  its 6.8 s and 3.4 GB a rank on H100s; made at first use, a pair's
  communicator could not be made while the card ran another NCCL
  transfer that waited on the peer, and four ranks hung (ROADMAP.md,
  R-4).

``destroy_collective_group`` waits for this rank's sends, then shuts the
group's process groups down in one order on every member: the
collectives' group, then the links that were made, by (source,
destination). An NCCL communicator's shutdown waits for its peers, and
four ranks that shut theirs down in orders of their own hung there
(ROADMAP.md, R-4).

All members of a group must call its collectives in the same order.
"""

from __future__ import annotations

import collections
import datetime
import importlib
import pickle
import queue
import socket
import threading
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple
from urllib.parse import urlparse

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

# A message's header on the wire: dtype code, kind, number of dims, then
# up to _MAX_DIMS sizes.
_MAX_DIMS = 8
_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool]
# What a value was, so that it comes back as the same kind.
_NUMPY, _TENSOR, _SCALAR = 0, 1, 2

# The rendezvous's and every collective's timeout: a member that never
# comes fails the others rather than wedging them.
_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass
class _GroupState:
    world_size: int
    rank: int
    group: Any                       # the collectives
    device: torch.device
    meet: Any     # the store the group meets in, read under its name
    store: Any    # the group's own store, kept while it stands (rank 0:
                  # served; None: the default world's)
    # Point to point: {(src, dst): the link's process group (src its rank
    # 0, dst its rank 1)}, the links this rank has made; and the thread
    # that sends to each peer this rank has sent to.
    links: Dict[Tuple[int, int], Any] = field(default_factory=dict)
    senders: Dict[int, "_Sender"] = field(default_factory=dict)
    lock: Any = field(default_factory=threading.Lock)
    mailbox: Deque[Any] = field(default_factory=collections.deque)


# Process state, kept in this module as the process imported it
# (_process(); the module doc says why): the groups joined, and the stores
# this process serves for groups it has not joined yet.
_groups: Dict[str, Optional[_GroupState]] = {}
_served: Dict[str, Any] = {}
_groups_lock = threading.Lock()


def _process():
    """This module as this process imported it (module doc)."""
    return importlib.import_module(__name__)


def _host_address() -> str:
    """The address other hosts reach this one at: what its name resolves
    to, if that is an address of this host, else the loopback."""
    try:
        addr = socket.gethostbyname(socket.gethostname())
        with socket.socket() as s:
            s.bind((addr, 0))
        return addr
    except OSError:
        return "127.0.0.1"


def open_collective_store(group_name: str = "default",
                          host: Optional[str] = None) -> str:
    """On the group's rank 0, before it joins: serve the group's store on a
    port the bind picks (on every interface) and keep it. ->
    ``tcp://host:port``, the ``init_method`` of every member. ``host``: the
    address the others reach this process at; by default the address this
    host's name resolves to (the loopback where that is not one of this
    host's), so pass it where the members' hosts know this one by
    another."""
    here = _process()
    with here._groups_lock:
        if group_name in here._groups or group_name in here._served:
            raise RuntimeError(
                f"group '{group_name}' already initialized here")
        store = here._served[group_name] = dist.TCPStore(
            "127.0.0.1", 0, is_master=True, timeout=_TIMEOUT,
            wait_for_workers=False)
    return f"tcp://{host or _host_address()}:{store.port}"


def _world_store(world_size: int, rank: int, group_name: str):
    """The default world's store under a prefix for this forming of the
    group (module doc). Rank 0 draws the number; each other member takes
    its copy off the store, so that the next forming's members wait for
    the next number."""
    world = dist.distributed_c10d._get_default_store()
    key = f"collective/{group_name}/"
    if rank == 0:
        n = world.add(key + "formed", 1)
        for r in range(1, world_size):
            world.set(f"{key}number/{r}", str(n))
    else:
        n = int(world.get(f"{key}number/{rank}"))
        world.delete_key(f"{key}number/{rank}")
    return dist.PrefixStore(f"{key}{n}/", world)


def _rendezvous(world_size: int, rank: int, group_name: str,
                init_method: Optional[str]):
    """-> (the store the group meets in, read under its name; the store to
    keep while the group stands) (module doc)."""
    here = _process()
    served = here._served.pop(group_name, None)
    if init_method is None:
        if world_size == 1:
            base = dist.HashStore()
        elif dist.is_initialized():
            return _world_store(world_size, rank, group_name), None
        else:
            raise ValueError(
                f"rank {rank} of group '{group_name}' (world {world_size}): "
                "give init_method, the address of the group's store "
                "(open_collective_store on its rank 0 returns it), or join a "
                "default world first")
    else:
        url = urlparse(init_method)
        if url.scheme != "tcp":
            raise ValueError(f"init_method {init_method!r}: tcp://host:port")
        if rank > 0:
            base = dist.TCPStore(url.hostname, url.port, is_master=False,
                                 timeout=_TIMEOUT)
        elif served is None:
            raise ValueError(
                f"rank 0 of group '{group_name}' serves the group's store: "
                "open it with open_collective_store before joining (it "
                "returns the init_method)")
        else:
            base = served
    return dist.PrefixStore(f"collective/{group_name}/", base), base


def _make_group(store, rank: int, size: int, backend: str,
                device: torch.device):
    """A process group of ``size`` members over ``store``, made from the
    store alone: nothing of the default world takes part. An NCCL group's
    communicator is made here, not at its first op."""
    pg = dist.ProcessGroup(store, rank, size)
    if backend == "nccl":
        options = dist.ProcessGroupNCCL.Options()
        options._timeout = _TIMEOUT
        impl = dist.ProcessGroupNCCL(dist.PrefixStore("cuda/", store), rank,
                                     size, options)
        kind = dist.ProcessGroup.BackendType.NCCL
        pg.bound_device_id = device
    else:
        impl = dist.ProcessGroupGloo(dist.PrefixStore("cpu/", store), rank,
                                     size, _TIMEOUT)
        kind = dist.ProcessGroup.BackendType.GLOO
    pg._set_default_backend(kind)
    pg._register_backend(torch.device(device.type), kind, impl)
    if backend == "nccl":
        impl.eager_connect_single_device(device)
    return pg


def _link(g: _GroupState, src: int, dst: int):
    """The gloo process group of the link ``src`` -> ``dst`` (this rank one
    of its ends), made at its first use; it waits for the other end to
    make it too."""
    key = (src, dst)
    with g.lock:
        pg = g.links.get(key)
    if pg is None:
        # A connection of the link's own to the store: a store client
        # serves one request at a time, and a link waiting in it for its
        # other end would hold up this rank's other links.
        pg = _make_group(dist.PrefixStore(f"p2p/{src}-{dst}/",
                                          g.meet.clone()),
                         int(g.rank == dst), 2, "gloo", torch.device("cpu"))
        with g.lock:
            g.links[key] = pg
    return pg


class _Sender:
    """This rank's messages to one peer, sent in order on a thread of
    their own, which makes the link first: ``send`` queues and returns. A
    marker (a ``threading.Event``) in the queue is set once every send
    before it has been posted; ``flush`` then waits for them to be
    received. After an error the rest are dropped and ``error`` holds
    it."""

    def __init__(self, g: _GroupState, dst: int):
        self.g, self.dst = g, dst
        self.queue: "queue.Queue[Any]" = queue.Queue()
        self.error: Optional[BaseException] = None
        self.works: List[Tuple[Any, torch.Tensor]] = []   # sends in flight
        self.thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"collective-send-{g.rank}-{dst}")
        self.thread.start()

    def _run(self) -> None:
        pg = None
        try:
            pg = _link(self.g, self.g.rank, self.dst)
        except BaseException as e:  # noqa: BLE001 — reported by flush
            self.error = e
        while True:
            item = self.queue.get()
            if item is None:
                return
            if isinstance(item, threading.Event):
                item.set()
                continue
            if self.error is not None:
                continue
            try:
                self.works = [(w, t) for w, t in self.works
                              if not w.is_completed()]
                for part in item:
                    self.works.append((pg.send([part], 1, 0), part))
            except BaseException as e:  # noqa: BLE001 — reported by flush
                self.error = e

    def flush(self) -> None:
        """Wait until every message queued so far has been received."""
        done = threading.Event()
        self.queue.put(done)
        done.wait()
        if self.error is not None:
            raise RuntimeError(f"collective send to rank {self.dst} "
                               f"failed") from self.error
        for work, _ in self.works:
            work.wait()
        self.works = []

    def stop(self) -> None:
        self.queue.put(None)
        self.thread.join()


def init_collective_group(world_size: int, rank: int,
                          backend: str = "gloo",
                          group_name: str = "default",
                          init_method: Optional[str] = None) -> None:
    """Join a collective group (call once on each member; returns when every
    member has joined). ``backend``: "gloo" (host tensors) or "nccl" (CUDA
    tensors, on the current device, which each member binds first).
    ``init_method``: where the group meets (module doc)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
    here = _process()
    with here._groups_lock:
        if group_name in here._groups:
            raise RuntimeError(
                f"group '{group_name}' already initialized here")
        here._groups[group_name] = None   # reserve against concurrent init
    try:
        store, base = _rendezvous(world_size, rank, group_name, init_method)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
        group = _make_group(store, rank, world_size, backend, device)
        state = _GroupState(world_size, rank, group, device, store, base)
    except BaseException:
        with here._groups_lock:
            here._groups.pop(group_name, None)
        raise
    with here._groups_lock:
        here._groups[group_name] = state


def destroy_collective_group(group_name: str = "default") -> None:
    """Leave the group: wait for this rank's sends, shut its process groups
    down and close its store (rank 0 serves it)."""
    here = _process()
    with here._groups_lock:
        state = here._groups.pop(group_name, None)
        here._served.pop(group_name, None)
    if state is None:
        return
    try:
        _flush(state)
    finally:
        for sender in state.senders.values():
            sender.stop()
    state.group.shutdown()
    for key in sorted(state.links):
        state.links[key].shutdown()


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _process()._groups


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world_size


def _group(group_name: str) -> _GroupState:
    here = _process()
    with here._groups_lock:
        g = here._groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group '{group_name}' not initialized; call "
            f"init_collective_group() first")
    return g


def _flush(g: _GroupState) -> None:
    """Wait for this rank's sends in flight."""
    for sender in list(g.senders.values()):
        sender.flush()


def pair_links(group_name: str = "default") -> List[Tuple[int, int]]:
    """The (source, destination) links this rank has made in the group,
    once the sends it has queued are out, in the order
    ``destroy_collective_group`` shuts them down."""
    g = _group(group_name)
    _flush(g)
    with g.lock:
        return sorted(g.links)


# ---------------------------------------------------------------------------
# Values: numpy, tensors, numbers, and trees of them
# ---------------------------------------------------------------------------

def _kind(x) -> int:
    if isinstance(x, torch.Tensor):
        return _TENSOR
    return _NUMPY if isinstance(x, np.ndarray) else _SCALAR


def _as_torch(x) -> torch.Tensor:
    """``x`` as a tensor where it lies (numpy: sharing its memory)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(np.asarray(x))


def _to_tensor(x, device: torch.device) -> torch.Tensor:
    """A copy of ``x`` on ``device`` (the collectives work in place; the
    caller's value stays as it was)."""
    return _as_torch(x).to(device, copy=True).contiguous()


def _as_kind(t: torch.Tensor, kind: int):
    """``t`` as a value of ``kind``: a tensor stays where it is."""
    if kind == _TENSOR:
        return t
    out = t.cpu().numpy()
    return out if kind == _NUMPY else out[()]


def _like(t: torch.Tensor, x):
    """``t`` as the kind of value ``x`` was (a tensor: on ``x``'s device)."""
    if isinstance(x, torch.Tensor):
        return t.to(x.device)
    return _as_kind(t, _kind(x))


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
    out = []
    for x in _leaves(tensor):
        t = _to_tensor(x, g.device)
        dist.all_reduce(t, op=_OPS[op], group=g.group)
        out.append(_like(t, x))
    return _rebuild(tensor, out)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = ReduceOp.SUM):
    g = _group(group_name)
    out = []
    for x in _leaves(tensor):
        t = _to_tensor(x, g.device)
        dist.reduce(t, group_dst=dst_rank, op=_OPS[op], group=g.group)
        out.append(_like(t, x))
    return _rebuild(tensor, out) if g.rank == dst_rank else tensor


def _header(t: Optional[torch.Tensor], kind: int,
            device: torch.device) -> torch.Tensor:
    """[dtype code, kind, ndim, sizes...]; -1 where there is no tensor."""
    h = torch.full((3 + _MAX_DIMS,), -1, dtype=torch.int64)
    if t is not None:
        if t.dim() > _MAX_DIMS:
            raise ValueError(f"{t.dim()} dims; at most {_MAX_DIMS}")
        h[0], h[1], h[2] = _DTYPES.index(t.dtype), kind, t.dim()
        h[3:3 + t.dim()] = torch.tensor(t.shape)
    return h.to(device)


def _from_header(h: torch.Tensor, device: torch.device
                 ) -> Tuple[torch.Tensor, int]:
    """An empty tensor of the header's dtype and shape, and its kind."""
    h = h.cpu().tolist()
    return (torch.empty(h[3:3 + h[2]], dtype=_DTYPES[h[0]], device=device),
            h[1])


def _broadcast_bytes(data: Optional[bytes], src_rank: int,
                     g: _GroupState) -> bytes:
    n = torch.tensor([len(data) if data is not None else 0],
                     dtype=torch.int64, device=g.device)
    dist.broadcast(n, group_src=src_rank, group=g.group)
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(g.device)
           if data is not None else
           torch.empty(int(n.item()), dtype=torch.uint8, device=g.device))
    dist.broadcast(buf, group_src=src_rank, group=g.group)
    return bytes(buf.cpu().numpy())


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """``src_rank``'s value (an array or a tree of them) on every rank; the
    others may pass None. The tree's layout travels first, then one buffer
    for each dtype of its leaves, into which ``src_rank`` copies each leaf
    once."""
    g = _group(group_name)
    mine = g.rank == src_rank
    layout = None
    if mine:
        given = _leaves(tensor)
        leaves = [_as_torch(x) for x in given]
        layout = pickle.dumps((
            _rebuild(tensor, [None] * len(leaves)),
            [(_DTYPES.index(t.dtype), _kind(x), tuple(t.shape))
             for t, x in zip(leaves, given)]))
    skeleton, specs = pickle.loads(_broadcast_bytes(layout, src_rank, g))
    out: List[Optional[torch.Tensor]] = [None] * len(specs)
    for code in sorted({code for code, _, _ in specs}):
        idx = [i for i, spec in enumerate(specs) if spec[0] == code]
        sizes = [int(np.prod(specs[i][2], dtype=np.int64)) for i in idx]
        flat = torch.empty(sum(sizes), dtype=_DTYPES[code], device=g.device)
        for i, part in zip(idx, flat.split(sizes)):
            out[i] = part.view(specs[i][2])
            if mine:
                out[i].copy_(leaves[i])
        dist.broadcast(flat, group_src=src_rank, group=g.group)
    if mine:
        values = [_like(t, x) for t, x in zip(out, given)]
    else:
        values = [_as_kind(t, kind) for t, (_, kind, _) in zip(out, specs)]
    return _rebuild(skeleton, values)


def allgather(tensor, group_name: str = "default") -> List:
    """Every rank's value, in rank order; their shapes may differ."""
    g = _group(group_name)
    t = _to_tensor(tensor, g.device)
    mine = _header(t, _kind(tensor), g.device)
    heads = [torch.empty_like(mine) for _ in range(g.world_size)]
    dist.all_gather(heads, mine, group=g.group)
    shapes = [_from_header(h, g.device)[0] for h in heads]
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
    t = _to_tensor(tensor, g.device)
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
    """Returns once every member has reached it (sends in flight may still
    be waiting for their receivers, as the reference's sends are held by
    its rendezvous): an allreduce of one element, read on the host."""
    g = _group(group_name)
    token = torch.zeros(1, device=g.device)
    dist.all_reduce(token, group=g.group)
    token.cpu()


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Post ``tensor`` to ``dst_rank``; returns without waiting for it to be
    received."""
    g = _group(group_name)
    if dst_rank == g.rank:
        g.mailbox.append((_to_tensor(tensor, g.device), _kind(tensor)))
        return
    if not 0 <= dst_rank < g.world_size:
        raise ValueError(f"dst_rank {dst_rank} out of range for world "
                         f"{g.world_size}")
    host = torch.device("cpu")
    t = _to_tensor(tensor, host)
    h = _header(t, _kind(tensor), host)
    with g.lock:
        sender = g.senders.get(dst_rank)
        if sender is None:
            sender = g.senders[dst_rank] = _Sender(g, dst_rank)
    sender.queue.put((h, t))


def recv(src_rank: int, group_name: str = "default"):
    """What ``src_rank``'s next send to this rank sent, as the kind of value
    it sent (a tensor: on the group's device)."""
    g = _group(group_name)
    if src_rank == g.rank:
        if not g.mailbox:
            raise RuntimeError(
                f"recv from this rank ({src_rank}) of group with no send "
                "posted to it")
        t, kind = g.mailbox.popleft()
        return _as_kind(t, kind)
    if not 0 <= src_rank < g.world_size:
        raise ValueError(f"src_rank {src_rank} out of range for world "
                         f"{g.world_size}")
    pg = _link(g, src_rank, g.rank)
    host = torch.device("cpu")
    h = _header(None, _NUMPY, host)
    pg.recv([h], 0, 0).wait()
    t, kind = _from_header(h, host)
    pg.recv([t], 0, 0).wait()
    return _as_kind(t.to(g.device) if kind == _TENSOR else t, kind)


# ---------------------------------------------------------------------------
# Groups of actors
# ---------------------------------------------------------------------------

def create_collective_group(actors, world_size: int, ranks: List[int],
                            backend: str = "gloo",
                            group_name: str = "default", runtime=None):
    """Declarative setup (the reference's declare-style API): joins each
    actor to the group as rank ``ranks[i]``, every rank of the group among
    them.

    The actors live behind ``runtime`` (``ray_tpu``, or None:
    ``util/local_runtime.py``, whose calls run at once in this process, so
    a group there has one member). For a group of more than one, rank 0's
    actor first opens the group's store (``open_collective_store(
    group_name)``, which returns its address: the one rank 0's host's name
    resolves to, which every member's host must reach, or the loopback,
    and then the members share a host); then every actor's
    ``setup_collective_group(world_size, rank, backend, group_name,
    init_method)`` gets that address. The easiest way to provide both
    methods is to inherit :class:`CollectiveGroupMixin`; otherwise define
    ``setup_collective_group`` to call ``init_collective_group(world_size,
    rank, backend, group_name, init_method)`` with what it is given, and
    ``open_collective_store`` to return ``open_collective_store(
    group_name)`` (this module's functions)."""
    from ray_tpu_torch.util import local_runtime
    actors, ranks = list(actors), list(ranks)
    if len(actors) != len(ranks):
        raise ValueError(f"{len(actors)} actors and {len(ranks)} ranks")
    if sorted(ranks) != list(range(world_size)):
        raise ValueError(f"ranks {ranks}: every rank of a world of "
                         f"{world_size}, once each")
    if runtime is None and world_size > 1:
        raise ValueError(
            f"world_size={world_size} needs a runtime to host the group: "
            "hand one in (runtime=ray_tpu, after ray_tpu.init()); without "
            "one the actors run in this process, and a group there has one "
            "member (world_size=1)")
    rt = local_runtime if runtime is None else runtime
    init_method = None
    if world_size > 1:
        init_method = rt.get(actors[ranks.index(0)]
                             .open_collective_store.remote(group_name))
    rt.get([actor.setup_collective_group.remote(
        world_size, rank, backend, group_name, init_method)
        for actor, rank in zip(actors, ranks)])


class CollectiveGroupMixin:
    """Mix into actor classes to make them joinable via
    create_collective_group()."""

    def setup_collective_group(self, world_size, rank, backend="gloo",
                               group_name="default", init_method=None):
        _process().init_collective_group(world_size, rank, backend,
                                         group_name, init_method)
        return True

    def open_collective_store(self, group_name="default", host=None):
        return _process().open_collective_store(group_name, host)
