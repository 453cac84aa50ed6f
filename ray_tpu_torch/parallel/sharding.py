"""Sharding strategies: the counterpart of ``ray_tpu/parallel/sharding.py``.

A strategy is a set of rules that give each parameter a per-axis spec, a
batch spec and the data axes, with the JAX package's presets (``dp``,
``fsdp``, ``tp``, ``tp_fsdp``, ``sp``, ``pp``, ``pp_tp``) and rules. A spec
is a tuple with one entry per dimension of the array: None (replicated),
a mesh axis name, or a tuple of axis names; it reads as the JAX
``PartitionSpec`` of the same name. Rules match on the parameter's path
under the JAX names (``layers/0/attn/wq``: the module's dotted name with
'/'); the first match wins.

``ShardingStrategy.param_specs(mesh, model)`` gives every parameter's spec.
The train step executes ``dp`` (``train/train_step.py``); turning the other
presets' specs into placements is the next slice's (ROADMAP queue 1).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Sequence, Tuple, Union

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
