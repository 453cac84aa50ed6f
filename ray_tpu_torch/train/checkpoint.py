"""Sharded checkpoints: the counterpart of ``save_pytree`` and
``load_pytree`` in ``ray_tpu/train/checkpoint.py``.

Each process writes the shards it holds, with no gather, in the JAX
package's files, entry for entry:

- ``<name>.h<proc>.npz``, one per process (``proc``: its rank in the
  world), with one entry per (leaf, shard) keyed ``"{i}|{start:stop,...}"``
  (the leaf's index in the flatten order, then the shard's slice of each
  dim) and ``"{i}|py"`` for a leaf that is no array (pickled, by process
  0). A shard held by several ranks (a replica) is written once, by the
  rank at coordinate 0 on every axis that does not split the leaf.
- ``<name>.index.json``: each leaf's global shape and dtype.
- ``<name>.leaves.json``: the leaves' paths, in order, in place of JAX's
  pickled treedef (the port cannot load a JAX treedef).

A ``TrainState`` flattens as JAX's does: ``params/<path>`` in JAX's order
(dict keys sorted, layers by index), then the AdamW state
``opt_state/0/count``, ``opt_state/0/mu/<path>``, ``opt_state/0/nu/<path>``
and ``step`` (count and step as int32 scalars, as in JAX). Each parameter's
shard slice comes from the model's placement (``parallel.sharding``): its
tensor, expert and pipeline slices, and the FSDP2 shard of a DTensor
(``to_local()``; FSDP2 pads an uneven dim, and only the rows the rank owns
are written). The moments are sharded as their parameters. Any other tree
of dicts and lists holds tensors (written whole, by process 0), DTensors
(each rank its shard, from the DTensor's placements), numpy arrays and
plain values.

``load_pytree`` assembles each leaf whole from every process's file. Given
a ``TrainState`` (of any mesh and strategy, or of one process) it copies
this rank's part of every leaf into the state's shards; without one it
returns the tree of whole tensors, or of DTensors where ``shardings`` names
a placement.

``Checkpoint`` (a reference to a directory, which ``report`` hands to the
driver) and ``new_checkpoint_dir`` are copies of JAX's (``_dict.pkl`` for
``from_dict``, as JAX writes it).
"""

from __future__ import annotations

import json
import math
import os
import pickle
import shutil
import tempfile
import uuid
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.sharding import entry_axes, local_params
from ray_tpu_torch.train.train_step import AdamWState, TrainState


class Checkpoint:
    """A reference to a directory of checkpoint data."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        with open(os.path.join(d, "_dict.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    def to_dict(self) -> Dict[str, Any]:
        p = os.path.join(self.path, "_dict.pkl")
        if not os.path.exists(p):
            raise ValueError(f"checkpoint at {self.path} has no dict payload")
        with open(p, "rb") as f:
            return pickle.load(f)

    def to_directory(self, path: Optional[str] = None) -> str:
        dst = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        if os.path.abspath(dst) != self.path:
            shutil.copytree(self.path, dst, dirs_exist_ok=True)
        return dst

    @contextmanager
    def as_directory(self):
        yield self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


def new_checkpoint_dir(storage_path: str, run_name: str, step: int) -> str:
    d = os.path.join(storage_path, run_name,
                     f"checkpoint_{step:06d}_{uuid.uuid4().hex[:6]}")
    os.makedirs(d, exist_ok=True)
    return d


@dataclass
class _Shard:
    """What this process holds of an array leaf: ``data`` (a tensor or a
    numpy array) at ``slices`` of the global ``shape``; ``write`` for the
    one copy among replicas."""
    data: Any
    shape: Tuple[int, ...]
    slices: Tuple[Tuple[int, int], ...]
    write: bool


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _jax_order(name: str):
    """Sort key of a dotted parameter name in JAX's flatten order."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def _param_shards(model: nn.Module) -> List[Tuple[str, int, _Shard]]:
    """(JAX path under params, index in named_parameters, this rank's
    shard) for every parameter, in JAX's order."""
    placement = getattr(model, "placement", None)
    named = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    local = local_params(model)
    out = []
    for i in sorted(range(len(named)), key=lambda j: _jax_order(named[j])):
        name, t = named[i], local[i].detach()
        path = name.replace(".", "/")
        if placement is None or placement.mesh.size == 1:
            shape = tuple(t.shape)
            out.append((path, i, _Shard(t, shape, tuple((0, n) for n in shape),
                                        _process_index() == 0)))
            continue
        mesh = placement.mesh
        coord = mesh.coordinate()
        shape = list(params[i].shape)     # a DTensor's: the sliced shape
        for dim, axes in placement._split(name, lambda a: a != "fsdp"):
            shape[dim] *= math.prod(mesh.shape[a] for a in axes)
        slices = []
        for dim, entry in enumerate(placement.specs[name]):
            start, n = 0, shape[dim]
            for a in entry_axes(entry):
                size = mesh.shape[a]
                if size == 1:
                    continue
                if a == "fsdp":
                    # FSDP2's chunks: ceil(n / size) rows, the last short.
                    start += coord[a] * -(-n // size)
                    n = t.shape[dim]
                else:
                    n //= size
                    start += coord[a] * n
            slices.append((start, start + n))
        split = placement.shard_axes(name)
        write = all(coord[a] == 0 for a in mesh.axis_names
                    if mesh.shape[a] > 1 and a not in split)
        out.append((path, i, _Shard(t, tuple(shape), tuple(slices), write)))
    return out


def _state_leaves(state: TrainState) -> List[Tuple[str, Any]]:
    """(path, leaf) of a TrainState in JAX's flatten order."""
    shards = _param_shards(state.params)
    opt = state.opt_state
    leaves = [("params/" + path, s) for path, _, s in shards]
    leaves.append(("opt_state/0/count", np.int32(opt.count)))
    for moment, tensors in (("mu", opt.mu), ("nu", opt.nu)):
        for path, i, s in shards:
            leaves.append((f"opt_state/0/{moment}/{path}", _Shard(
                tensors[i].detach(), s.shape, s.slices, s.write)))
    leaves.append(("step", np.int32(state.step)))
    return leaves


def _tree_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of a TrainState, or of a tree of dicts (keys sorted),
    lists and tuples."""
    if isinstance(tree, TrainState):
        return _state_leaves(tree)
    if isinstance(tree, Mapping):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(_tree_leaves(sub, f"{prefix}/{key}" if prefix else key))
    return out


def _as_shard(leaf) -> Optional[_Shard]:
    """An array leaf as a _Shard; None for a leaf that is no array."""
    if isinstance(leaf, _Shard):
        return leaf
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        local = leaf.to_local().detach()
        _, offset = compute_local_shape_and_global_offset(
            leaf.shape, leaf.device_mesh, leaf.placements)
        coord = leaf.device_mesh.get_coordinate()
        for p in leaf.placements:
            if p.is_partial():
                raise ValueError("a DTensor with a Partial placement holds "
                                 "no shard of its value; reduce it first")
        write = all(c == 0 for c, p in zip(coord, leaf.placements)
                    if p.is_replicate())
        return _Shard(local, tuple(leaf.shape),
                      tuple((o, o + n) for o, n in zip(offset, local.shape)),
                      write)
    if isinstance(leaf, (torch.Tensor, np.ndarray, np.generic)):
        shape = tuple(leaf.shape)
        return _Shard(leaf, shape, tuple((0, n) for n in shape),
                      _process_index() == 0)
    return None


def _to_numpy(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def _slice_key(slices) -> str:
    return ",".join(f"{a}:{b}" for a, b in slices)


def _parse_slice_key(key: str):
    if not key:
        return ()
    return tuple(slice(int(a), int(b)) for a, b in
                 (part.split(":") for part in key.split(",")))


def save_pytree(tree: Any, directory: str, *, name: str = "state",
                process_index: Optional[int] = None) -> None:
    """Write this process's shards of ``tree`` (a ``TrainState``, a model,
    or a tree of dicts and lists; module doc). Every process of the world
    calls it; it returns when every file is written."""
    os.makedirs(directory, exist_ok=True)
    proc = _process_index() if process_index is None else process_index
    leaves = _tree_leaves(tree)
    arrays: Dict[str, np.ndarray] = {}
    index: Dict[str, Any] = {"leaves": [], "name": name}
    for i, (_, leaf) in enumerate(leaves):
        shard = _as_shard(leaf)
        if shard is None:
            index["leaves"].append({"i": i, "py": True})
            if proc == 0:
                arrays[f"{i}|py"] = np.frombuffer(pickle.dumps(leaf),
                                                  dtype=np.uint8)
            continue
        arr = _to_numpy(shard.data)
        index["leaves"].append({"i": i, "shape": list(shard.shape),
                                "dtype": str(arr.dtype)})
        if shard.write:
            arrays[f"{i}|{_slice_key(shard.slices)}"] = arr
    np.savez(os.path.join(directory, f"{name}.h{proc}.npz"), **arrays)
    if proc == 0:
        with open(os.path.join(directory, f"{name}.index.json"), "w") as f:
            json.dump(index, f)
        with open(os.path.join(directory, f"{name}.leaves.json"), "w") as f:
            json.dump([path for path, _ in leaves], f)
    if dist.is_initialized():
        dist.barrier()


def _read(directory: str, name: str) -> Dict[str, Any]:
    """{path: the whole leaf (a CPU tensor, or the plain value)}."""
    with open(os.path.join(directory, f"{name}.leaves.json")) as f:
        paths = json.load(f)
    with open(os.path.join(directory, f"{name}.index.json")) as f:
        index = json.load(f)
    shards: Dict[int, list] = {}
    plain: Dict[int, Any] = {}
    for fn in sorted(os.listdir(directory)):
        if not (fn.startswith(f"{name}.h") and fn.endswith(".npz")):
            continue
        with np.load(os.path.join(directory, fn)) as z:
            for key in z.files:
                si, idx = key.split("|", 1)
                if idx == "py":
                    plain[int(si)] = pickle.loads(z[key].tobytes())
                else:
                    shards.setdefault(int(si), []).append((idx, z[key]))
    out = {}
    for meta in index["leaves"]:
        i = meta["i"]
        if meta.get("py"):
            out[paths[i]] = plain[i]
            continue
        full = np.empty(tuple(meta["shape"]), dtype=np.dtype(meta["dtype"]))
        for idx, arr in shards.get(i, []):
            full[_parse_slice_key(idx)] = arr
        out[paths[i]] = torch.from_numpy(full)
    return out


def _restore(state: TrainState, leaves: Dict[str, Any]) -> TrainState:
    """Copy this rank's part of every saved leaf into ``state``'s shards."""
    model = state.params
    placement = getattr(model, "placement", None)
    opt = state.opt_state
    with torch.no_grad():
        for (name, _), shard, mu, nu in zip(model.named_parameters(),
                                            local_params(model), opt.mu,
                                            opt.nu):
            path = name.replace(".", "/")
            for prefix, dst in (("params/", shard), ("opt_state/0/mu/", mu),
                                ("opt_state/0/nu/", nu)):
                key = prefix + path
                if key not in leaves:
                    raise KeyError(f"the checkpoint holds no {key!r}")
                full = leaves[key]
                if placement is not None:
                    full = placement.local(name, full)
                dst.copy_(full)
    return TrainState(model, AdamWState(opt.mu, opt.nu, int(
        leaves["opt_state/0/count"])), int(leaves["step"]))


def _spec_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of a tree of dicts whose leaves are placements."""
    if not isinstance(tree, Mapping):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(_spec_leaves(tree[key],
                                f"{prefix}/{key}" if prefix else str(key)))
    return out


def load_pytree(directory: str, *, name: str = "state",
                state: Optional[TrainState] = None,
                shardings: Any = None) -> Any:
    """Restore what ``save_pytree`` wrote (module doc). ``state``: a
    TrainState to fill in place (returned, with the saved AdamW count and
    step). Else the tree (nested dicts by path) of whole CPU tensors, or
    plain values; ``shardings``, a tree of the same paths with
    ``(DeviceMesh, placements)`` or None at its leaves, makes a DTensor of
    each named leaf from the whole value every rank holds."""
    leaves = _read(directory, name)
    if state is not None:
        return _restore(state, leaves)
    placements = {path: sh for path, sh in _spec_leaves(shardings)
                  if sh is not None}
    out: Dict[str, Any] = {}
    for path, val in leaves.items():
        if path in placements:
            from torch.distributed.tensor import distribute_tensor
            mesh, spec = placements[path]
            val = distribute_tensor(val.to(mesh.device_type), mesh, spec,
                                    src_data_rank=None)
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return out
