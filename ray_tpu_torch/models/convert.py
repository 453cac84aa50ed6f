"""Move GPT parameters between the JAX param tree and the torch module.

The JAX tree is nested dicts and lists with numpy leaves (``np.asarray`` of
``ray_tpu.models.gpt.gpt_init``'s output); the module's ``state_dict`` uses
the same names joined by dots (``layers.0.attn.wq``), with the same
shapes, so nothing is transposed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{dotted name: leaf} for a tree of dicts and lists."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(flatten(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> ``state_dict`` for ``GPT``."""
    return {name: torch.from_numpy(np.array(leaf))
            for name, leaf in flatten(tree).items()}


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of ``flatten``: numeric path parts become list indices."""
    root: Dict[str, Any] = {}
    for name, leaf in flat.items():
        node = root
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def params_to_numpy(model: nn.Module) -> Dict[str, Any]:
    """The module's parameters as a JAX-shaped tree of numpy arrays."""
    return unflatten({name: p.detach().cpu().numpy()
                      for name, p in model.named_parameters()})
