"""The port of ``ray_tpu/serve/proxy.py:_jsonable`` (:644), the proxy's
conversion of a deployment's result to JSON: it knows ``torch.Tensor``
(detached, moved to the host, ``.tolist()``) where JAX's knows
``jax.Array``. The proxy itself holds no JAX and is not copied."""

from __future__ import annotations

import numpy as np
import torch


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().tolist()
    return x
