"""Move GPT parameters between the JAX param tree and the torch module.

The JAX tree is nested dicts and lists with numpy leaves (``np.asarray`` of
``ray_tpu.models.gpt.gpt_init``'s output); the module's ``state_dict`` uses
the same names joined by dots (``layers.0.attn.wq``), with the same
shapes, so nothing is transposed. A model placed on a mesh
(``parallel.sharding.shard_params``) takes the JAX values straight into
each rank's shards (``load_params``), and gives its whole parameters back
as the JAX tree (``params_to_numpy``, which every rank calls). The same
functions move the pipeline layout (``parallel.pipeline.StackedGPT``, the
JAX tree with ``stacked`` in place of ``layers``): its names are JAX's
too, and a placed model's stage slices are its shards.
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


@torch.no_grad()
def load_params(model: nn.Module, tree: Any) -> None:
    """Copy a JAX param tree (numpy leaves) into ``model``'s parameters, or,
    for a placed model, each leaf's part on this rank into its shard."""
    from ray_tpu_torch.parallel.sharding import local_params
    flat = flatten(tree)
    placement = getattr(model, "placement", None)
    for (name, _), shard in zip(model.named_parameters(),
                                local_params(model)):
        full = torch.from_numpy(np.array(flat[name]))
        if placement is not None:
            full = placement.local(name, full)
        shard.copy_(full)


def params_to_numpy(model: nn.Module) -> Dict[str, Any]:
    """The module's whole parameters as a JAX-shaped tree of numpy arrays
    (gathered from the shards of a placed model: every rank calls it)."""
    from ray_tpu_torch.parallel.sharding import gather_params
    return unflatten({name: p.cpu().numpy()
                      for name, p in gather_params(model).items()})
