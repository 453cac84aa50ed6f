"""The device feed: the counterpart of ``ray_tpu/data/iterator.py:
jax_batch_stream`` with ``ray_tpu/parallel/sharding.py:batch_sharding``.

``device_batch_stream(batches, mesh, strategy)`` turns any iterator of
numpy batches (dicts of arrays, such as ``Dataset.iter_batches`` yields)
into this rank's rows as torch tensors on this rank's device: the rows
that the train step takes by the strategy's batch spec
(``train_step._DataParallel``), dim 0, or dim 1 under ``accum_steps``.
Each array goes through pinned host memory and is copied with
``non_blocking=True``, so the copy overlaps the work already queued on the
card. Each batch comes as a ``train_step.LocalBatch``, which
``make_train_step`` and ``make_eval_step`` of the same mesh and strategy
take as it is.

No method is added to a dataset: the function takes any iterator.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.parallel.sharding import ShardingStrategy
from ray_tpu_torch.train.train_step import LocalBatch, _DataParallel


def device_batch_stream(batches: Iterable[Dict[str, Any]],
                        mesh: Optional[Mesh] = None,
                        strategy: Union[ShardingStrategy, str, None] = None,
                        *, dtype: Optional[torch.dtype] = None,
                        device=None, accum_steps: int = 0
                        ) -> Iterator[LocalBatch]:
    """numpy batches -> this rank's rows as tensors on its device.

    ``mesh`` and ``strategy`` as the train step's (None: one device, every
    row; ``device`` then names it, default the card). ``dtype`` casts each
    array (a torch dtype)."""
    plan = _DataParallel(mesh, strategy)
    dev = plan.device if plan.device is not None else resolve_device(device)
    dim = 1 if accum_steps else 0
    for batch in batches:
        out = {}
        for key, val in batch.items():
            rows = np.ascontiguousarray(plan.take(key, np.asarray(val), dim))
            if not rows.flags.writeable:
                rows = rows.copy()
            t = torch.from_numpy(rows)
            if dtype is not None:
                t = t.to(dtype)
            if dev.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(dev, non_blocking=True)
        yield LocalBatch(out, (plan.index, plan.size, dim))
