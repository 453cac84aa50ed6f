"""Sharding strategies: the counterpart of ``ray_tpu/parallel/sharding.py``.

A strategy is a set of rules that give each parameter a per-axis spec, a
batch spec and the data axes, with the JAX package's presets (``dp``,
``fsdp``, ``tp``, ``tp_fsdp``, ``sp``, ``pp``, ``pp_tp``) and rules. A spec
is a tuple with one entry per dimension of the array: None (replicated),
a mesh axis name, or a tuple of axis names; it reads as the JAX
``PartitionSpec`` of the same name. Rules match on the parameter's path
under the JAX names (``layers/0/attn/wq``: the module's dotted name with
'/'); the first match wins.

``ShardingStrategy.param_specs(mesh, model)`` gives every parameter's spec,
and ``shard_params(model, mesh, strategy)`` turns the specs into this
rank's shards, the spec being the single source of truth: each rank holds
of every parameter what the JAX array holds on the device at the same mesh
coordinate. The tensor, expert and pipeline axes leave a plain tensor,
this rank's slice (Megatron style: the CUDA kernels take plain contiguous
tensors; the pipeline axis keeps a stage's layers of the stacked layout,
``parallel.pipeline``); the
fsdp axis goes to FSDP2, ``fully_shard`` on each layer and on the root over
the fsdp sub-mesh, with each parameter's sharded dim taken from its spec
and gradients summed, not averaged. ``gather_params`` returns the whole
parameters, ``local_params`` the shards that the optimizer updates.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

Spec = Tuple[Any, ...]


class _FsdpLargestMarker:
    """Sentinel: shard the largest divisible dim over 'fsdp'."""

    def __repr__(self):
        return "FSDP_LARGEST"


FSDP_LARGEST = _FsdpLargestMarker()


class _PpStackedMarker:
    """Sentinel: shard the leading (stacked-layer) dim over 'pipeline'."""

    def __repr__(self):
        return "PP_STACKED"


PP_STACKED = _PpStackedMarker()


@dataclass
class ShardingRules:
    """Ordered (regex, spec) rules + a default."""

    rules: List[Tuple[str, Any]] = field(default_factory=list)
    default: Any = ()

    def spec_for(self, path: str, shape: Tuple[int, ...]):
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                if spec is FSDP_LARGEST:
                    return spec
                if spec is PP_STACKED:
                    return ("pipeline",) + (None,) * (max(len(shape), 1) - 1)
                return _truncate_spec(spec, shape)
        if self.default is FSDP_LARGEST:
            return self.default
        return _truncate_spec(self.default, shape)


def _truncate_spec(spec: Spec, shape: Tuple[int, ...]) -> Spec:
    """Trim/pad a spec to the array rank so one rule covers kernel+bias."""
    parts = tuple(spec)
    if len(parts) > len(shape):
        parts = parts[-len(shape):] if len(shape) > 0 else ()
    elif len(parts) < len(shape):
        parts = (None,) * (len(shape) - len(parts)) + parts
    return parts


def _subdivide_largest(spec, shape: Tuple[int, ...], mesh) -> Spec:
    if spec is not FSDP_LARGEST:
        return spec
    fsdp_size = mesh.shape.get("fsdp", 1)
    if fsdp_size <= 1 or not shape:
        return ()
    # Pick the largest dim divisible by the fsdp axis.
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size:
            parts: List = [None] * len(shape)
            parts[i] = "fsdp"
            return tuple(parts)
    return ()


class ShardingStrategy:
    """A named parallelism strategy = param rules + batch spec.

      dp    -> pure data parallel (params replicated)
      fsdp  -> ZeRO-3: params/opt-state sharded over ('fsdp',) largest dim
      tp    -> Megatron-style tensor parallel over 'tensor'
      tp_fsdp -> TP inner + FSDP outer
      sp    -> sequence parallel: batch sharded over tokens ('sequence')
      pp / pp_tp -> stacked layers over 'pipeline' (+ TP inside a stage)
    """

    def __init__(self, name: str, param_rules: ShardingRules,
                 batch_spec: Spec, data_axes: Sequence[str] = ("data",)):
        self.name = name
        self.param_rules = param_rules
        self.batch_spec = tuple(batch_spec)
        self.data_axes = tuple(data_axes)

    # ---- presets ----

    @staticmethod
    def dp() -> "ShardingStrategy":
        return ShardingStrategy("dp", ShardingRules(), ("data",))

    @staticmethod
    def fsdp() -> "ShardingStrategy":
        """ZeRO-3: every weight matrix sharded on its largest dim over
        ('fsdp',)."""
        rules = ShardingRules(rules=[(r".*", FSDP_LARGEST)], default=())
        return ShardingStrategy("fsdp", rules, (("data", "fsdp"),))

    @staticmethod
    def tp_transformer() -> "ShardingStrategy":
        """Megatron TP for the GPT layout: column-parallel qkv/up
        projections, row-parallel out/down."""
        t = "tensor"
        rules = ShardingRules(rules=[
            (r"attn/(wq|wk|wv)", (None, t)),
            (r"attn/wo", (t, None)),
            (r"mlp/(w_up|w_gate)", (None, t)),
            (r"mlp/w_down", (t, None)),
            (r"embed/table", (t, None)),
            (r"lm_head", (None, t)),
            (r"moe/.*w_up", ("expert", None, t)),
            (r"moe/.*w_down", ("expert", t, None)),
            (r"moe/router", (None, None)),
        ], default=())
        return ShardingStrategy("tp", rules, ("data",))

    @staticmethod
    def tp_fsdp() -> "ShardingStrategy":
        """2D: TP inner + FSDP outer on the complementary dim."""
        t = "tensor"
        f = "fsdp"
        rules = ShardingRules(rules=[
            (r"attn/(wq|wk|wv)", (f, t)),
            (r"attn/wo", (t, f)),
            (r"mlp/(w_up|w_gate)", (f, t)),
            (r"mlp/w_down", (t, f)),
            # Vocab over both axes, d_model replicated (the JAX module
            # says why).
            (r"embed/table", ((t, f), None)),
            (r"lm_head", (f, t)),
            (r"moe/.*w_up", ("expert", f, t)),
            (r"moe/.*w_down", ("expert", t, f)),
            (r"moe/router", (None, None)),
        ], default=FSDP_LARGEST)
        return ShardingStrategy("tp_fsdp", rules, (("data", "fsdp"),))

    @staticmethod
    def pp() -> "ShardingStrategy":
        """Pipeline parallel: stacked layer params sharded on the leading
        (layer) axis over 'pipeline'."""
        rules = ShardingRules(rules=[(r"stacked/", PP_STACKED)], default=())
        return ShardingStrategy("pp", rules, ("data",))

    @staticmethod
    def pp_tp() -> "ShardingStrategy":
        """Pipeline outer + Megatron tensor parallel inside each stage."""
        t = "tensor"
        pl = "pipeline"
        rules = ShardingRules(rules=[
            (r"stacked/attn/(wq|wk|wv)", (pl, None, t)),
            (r"stacked/attn/wo", (pl, t, None)),
            (r"stacked/mlp/(w_gate|w_up)", (pl, None, t)),
            (r"stacked/mlp/w_down", (pl, t, None)),
            (r"stacked/", PP_STACKED),
        ], default=())
        return ShardingStrategy("pp_tp", rules, ("data",))

    @staticmethod
    def sp() -> "ShardingStrategy":
        """Sequence/context parallel: tokens sharded over 'sequence'."""
        return ShardingStrategy("sp", ShardingRules(), ("data", "sequence"))

    @staticmethod
    def sp_ep() -> "ShardingStrategy":
        """The JAX package's multi-chip dry run's "sp_ep" (no preset there):
        MoE experts over 'expert', the router and everything else
        replicated, rows over 'data'; the model splits the tokens over
        'sequence' and needs ring attention."""
        return ShardingStrategy("sp_ep", ShardingRules(rules=[
            (r"moe/.*w_(gate|up|down)", ("expert", None, None)),
            (r"moe/router", ())], default=()), ("data",))

    @property
    def activation_spec(self) -> Spec:
        """Canonical spec for [batch, seq, d_model] activations."""
        parts = tuple(self.batch_spec)
        if len(parts) > 3:
            raise ValueError(f"batch_spec {self.batch_spec} has rank > 3")
        return parts + (None,) * (3 - len(parts))

    def param_specs(self, mesh, params: Union[nn.Module, Mapping[str, Any]]
                    ) -> Dict[str, Spec]:
        """{JAX path: spec} for every parameter of ``params`` (a module, or
        a mapping from dotted or '/'-joined names to arrays)."""
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        out = {}
        for name, leaf in params.items():
            path = name.replace(".", "/")
            shape = tuple(leaf.shape)
            spec = self.param_rules.spec_for(path, shape)
            out[path] = _subdivide_largest(spec, shape, mesh)
        return out


def strategy_from_name(name: str) -> ShardingStrategy:
    presets = {
        "dp": ShardingStrategy.dp,
        "fsdp": ShardingStrategy.fsdp,
        "tp": ShardingStrategy.tp_transformer,
        "tp_fsdp": ShardingStrategy.tp_fsdp,
        "sp": ShardingStrategy.sp,
        "pp": ShardingStrategy.pp,
        "pp_tp": ShardingStrategy.pp_tp,
    }
    if name not in presets:
        raise ValueError(f"unknown strategy '{name}'; one of {list(presets)}")
    return presets[name]()


# ---------------------------------------------------------------------------
# Placements: the specs turned into this rank's shards
# ---------------------------------------------------------------------------

# Axes that leave this rank a plain slice of a parameter (the pipeline
# axis: its stage's layers of the stacked layout); "fsdp" goes to FSDP2.
# The batch axes never split a parameter.
_SLICE_AXES = ("tensor", "expert", "pipeline")


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: None, a name, or a tuple of names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Placement:
    """Where each parameter of a model lives on ``mesh``: its spec, keyed by
    the dotted name, and whether FSDP2 holds a part of any (``fsdp``: the
    axis has more than one rank and some spec splits a dim over it)."""

    def __init__(self, mesh, specs: Dict[str, Spec]):
        self.mesh = mesh
        self.specs = specs
        self.fsdp = any(self.fsdp_dim(n) is not None for n in specs)

    def _split(self, name: str, keep) -> List[Tuple[int, Tuple[str, ...]]]:
        """[(dim, the axes of size > 1 that split it, in the entry's order)]
        for the axes that ``keep`` admits."""
        out = []
        for dim, entry in enumerate(self.specs[name]):
            axes = tuple(a for a in entry_axes(entry)
                         if keep(a) and self.mesh.shape[a] > 1)
            if axes:
                out.append((dim, axes))
        return out

    def shard_axes(self, name: str) -> Tuple[str, ...]:
        """The axes of size > 1 that split the parameter, in canonical
        order: its global sum of squares sums over their group."""
        axes = {a for _, ax in self._split(name, lambda a: True) for a in ax}
        return tuple(a for a in self.mesh.axis_names if a in axes)

    def split_dim(self, name: str, axis: str) -> Optional[int]:
        """The dim of the parameter that ``axis`` splits (None: the
        parameter is whole over the axis, or the axis has one rank)."""
        dims = self._split(name, lambda a: a == axis)
        return dims[0][0] if dims else None

    def fsdp_dim(self, name: str) -> Optional[int]:
        """The dim FSDP2 shards (None: the parameter is whole over fsdp)."""
        return self.split_dim(name, "fsdp")

    def local(self, name: str, full: torch.Tensor,
              axes: Sequence[str] = ("fsdp",) + _SLICE_AXES) -> torch.Tensor:
        """This rank's part of the whole parameter ``full`` over ``axes``."""
        coord = self.mesh.coordinate()
        for dim, names in self._split(name, lambda a: a in axes):
            index, size = 0, 1
            for a in names:
                index = index * self.mesh.shape[a] + coord[a]
                size *= self.mesh.shape[a]
            n = full.shape[dim] // size
            full = full.narrow(dim, index * n, n)
        return full

    def check(self, name: str, shape: Tuple[int, ...]) -> None:
        """Raise ValueError where the spec cannot be placed: an axis that is
        not a parameter axis or is named twice, a dim its axes do not
        divide, fsdp on two dims or before a sliced axis in one entry."""
        fsdp_dims = 0
        named = [a for e in self.specs[name] for a in entry_axes(e)]
        if len(set(named)) < len(named):
            raise ValueError(f"{name}: spec {self.specs[name]} names an "
                             "axis twice")
        for dim, entry in enumerate(self.specs[name]):
            axes = entry_axes(entry)
            bad = [a for a in axes if a not in _SLICE_AXES + ("fsdp",)]
            if bad:
                raise ValueError(f"{name}: spec {self.specs[name]} splits a "
                                 f"parameter over {bad}, which the port does "
                                 "not place (only fsdp, tensor, expert and "
                                 "pipeline)")
            size = math.prod(self.mesh.shape[a] for a in axes)
            if shape[dim] % size:
                raise ValueError(
                    f"{name}: dim {dim} of size {shape[dim]} does not divide "
                    f"over the {'x'.join(axes)} axis ({size}); the port "
                    "does not fall back to replication")
            live = [a for a in axes if self.mesh.shape[a] > 1]
            if "fsdp" in live:
                fsdp_dims += 1
                if live[-1] != "fsdp":
                    raise ValueError(f"{name}: fsdp must come after the "
                                     f"other axes of dim {dim} in {entry}")
            sliced = [a for a in live if a in _SLICE_AXES]
            if len(sliced) > 1:
                raise ValueError(f"{name}: dim {dim} splits over both "
                                 f"{sliced[0]} and {sliced[1]} ({entry})")
        if fsdp_dims > 1:
            raise ValueError(f"{name}: FSDP2 shards one dim, the spec "
                             f"{self.specs[name]} splits {fsdp_dims} over fsdp")


def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner), leaf, nn.Parameter(value))


def shard_params(model: nn.Module, mesh, strategy: Union[ShardingStrategy,
                                                          str]) -> Placement:
    """Leave this rank's shards of ``model``'s (whole) parameters in place,
    as ``strategy`` places them on ``mesh`` (``build_mesh``); returns the
    placement, also kept as ``model.placement``.

    Tensor, expert and pipeline axes: the parameter becomes its plain
    slice. The
    fsdp axis, where it has more than one rank: FSDP2's ``fully_shard`` on
    each of ``model.layers`` and on the root, over the fsdp sub-mesh, with
    each parameter's sharded dim taken from its spec (``FSDP_LARGEST``
    resolved as JAX's ``_subdivide_largest`` does) and parameters whole
    over fsdp left out (``ignored_params``); gradients are summed over the
    axis (divide factor 1), not averaged. A dim that its axes do not divide
    raises ValueError, naming the parameter and the axis, as does the
    model's own ``check_placement`` where it has one (the GPT's heads)."""
    if isinstance(strategy, str):
        strategy = strategy_from_name(strategy)
    previous = getattr(model, "placement", None)
    if previous is not None and max(previous.mesh.size, mesh.size) > 1:
        raise ValueError("the model is placed already; place a whole model")
    paths = strategy.param_specs(mesh, model)
    named = dict(model.named_parameters())
    placement = Placement(mesh, {n: paths[n.replace(".", "/")]
                                 for n in named})
    for name, p in named.items():
        placement.check(name, tuple(p.shape))
    if hasattr(model, "check_placement"):
        model.check_placement(placement)
    for name, p in named.items():
        part = placement.local(name, p.detach(), _SLICE_AXES)
        if part.shape != p.shape:
            _set_param(model, name, part.contiguous())
    if placement.fsdp:
        _fully_shard(model, mesh, placement)
    model.placement = placement
    return placement


def _fully_shard(model: nn.Module, mesh, placement: Placement) -> None:
    from torch.distributed.fsdp import FSDPModule, fully_shard
    from torch.distributed.tensor import Shard
    dims = {p: placement.fsdp_dim(n) for n, p in model.named_parameters()}
    kwargs = dict(mesh=mesh.device_mesh["fsdp"],
                  shard_placement_fn=lambda p: Shard(dims[p]),
                  ignored_params={p for p, d in dims.items() if d is None})
    for layer in getattr(model, "layers", ()):
        fully_shard(layer, **kwargs)
    fully_shard(model, **kwargs)
    for module in model.modules():
        if isinstance(module, FSDPModule):
            module.set_gradient_divide_factor(1.0)
            module.set_force_sum_reduction_for_comms(True)


def local_params(model: nn.Module) -> List[torch.Tensor]:
    """This rank's shard of every parameter, as plain tensors whose storage
    is the parameter's (an in-place update is the next step's weight)."""
    from torch.distributed.tensor import DTensor
    with torch.no_grad():
        return [p.to_local() if isinstance(p, DTensor) else p
                for p in model.parameters()]


def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{dotted name: the whole parameter} on every rank, from the shards of
    a placed model (the parameters themselves where none is placed). Every
    rank of the world must call it."""
    from torch.distributed.tensor import DTensor
    placement = getattr(model, "placement", None)
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if placement is not None:
            for dim, axes in placement._split(
                    name, lambda a: a in _SLICE_AXES):
                group = placement.mesh.group(axes)
                parts = [torch.empty_like(t) for _ in range(
                    dist.get_world_size(group))]
                dist.all_gather(parts, t.contiguous(), group=group)
                t = torch.cat(parts, dim=dim)
        out[name] = t
    return out
