"""Move RLlib parameters between JAX param trees and the port's modules.

The JAX trees are nested dicts and lists with numpy leaves (``np.asarray``
of a JAX learner's ``params``); the port's networks name their parameters
by the same paths joined by dots (``torso.layers.0.w``, ``lstm.wx``,
``pi.1.b``) with the same shapes, so nothing is renamed or transposed.

``ravel`` / ``unravel`` are ``jax.flatten_util.ravel_pytree``'s flat vector:
leaves in the tree's flatten order (dict keys sorted, lists in order), each
flattened row-major and concatenated. ES and ARS draw their noise at that
length from a seed, so a JAX flat vector and the port's are the same
vector.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.models.convert import params_from_jax

__all__ = ["params_from_jax", "load_jax", "ravel", "unravel",
           "load_learner"]


def load_jax(module: nn.Module, tree: Any) -> None:
    """Copy a JAX param tree (numpy leaves) into ``module``."""
    module.load_state_dict(params_from_jax(tree))


def _path_key(name: str):
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def _ravel_order(names) -> list:
    """Parameter names in ``ravel_pytree``'s leaf order: at each level dict
    keys sorted as strings, list entries by index."""
    return sorted(names, key=_path_key)


def ravel(weights) -> np.ndarray:
    """A module or a state dict -> the float32 flat vector of
    ``ravel_pytree``."""
    if isinstance(weights, nn.Module):
        weights = weights.state_dict()
    return np.concatenate([
        weights[k].detach().cpu().numpy().reshape(-1).astype(np.float32)
        for k in _ravel_order(weights)])


def unravel(module: nn.Module, flat) -> Dict[str, torch.Tensor]:
    """Inverse of ``ravel``: a state dict for ``module`` (on its device)."""
    flat = np.asarray(flat, np.float32)
    state = module.state_dict()
    total = sum(v.numel() for v in state.values())
    if flat.size != total:
        raise ValueError(f"flat vector of {flat.size} for a module of "
                         f"{total} parameters")
    out, at = {}, 0
    for k in _ravel_order(state):
        ref = state[k]
        out[k] = torch.as_tensor(
            flat[at:at + ref.numel()].reshape(ref.shape), device=ref.device)
        at += ref.numel()
    return out


def load_learner(learner, params: Any,
                 target: Optional[Any] = None) -> None:
    """Carry a JAX learner's trees into a port learner: ``params`` into its
    module and, for a learner with a target network, ``target`` (default:
    ``params``, as a fresh JAX learner's target is) into its target."""
    learner.set_weights(params_from_jax(params))
    if hasattr(learner, "target"):
        learner.target.load_state_dict(
            params_from_jax(params if target is None else target))

