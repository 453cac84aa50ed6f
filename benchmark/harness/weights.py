"""Weights and tokens drawn from ``--seed``. The same seed gives the same
numbers to the program and to the reference: a block (the embedding, final
norm and head; or one layer) is one ``torch.randn`` call on the device from
a generator seeded by (seed, block), so either side can draw any block again
alone. Imports nothing of the program."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

_WEIGHTS, _TOKENS = 0xB10C, 0x70CE


def _stream(seed: int, *key: int) -> int:
    """A 64-bit seed for one stream of one run's seed."""
    ss = np.random.SeedSequence([seed % (1 << 64), *key])
    return int(ss.generate_state(1, np.uint64)[0])


def block_weights(spec, seed: int, block: int,
                  device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor} of one block (the spec's ``blocks()``), drawn in
    one call at the spec's ``init_scale``; the tensors are views of one
    buffer, and leaves of one dimension (norm scales) are ones."""
    leaves = spec.blocks()[block]
    drawn = [(n, s) for n, s in leaves if len(s) > 1]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(_stream(seed, _WEIGHTS, block))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape in leaves:
        if len(shape) == 1:
            out[name] = torch.ones(shape, device=device, dtype=torch.float32)
            continue
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(
            spec.init_scale(name, shape))
        at += n
    return out


def token_pool(seed: int, pool: int, batch: int, seq: int,
               vocab: int) -> np.ndarray:
    """[pool, batch, seq + 1] int64 token ids, uniform over the vocabulary:
    ``pool`` global batches, inputs and their next-token targets."""
    rng = np.random.Generator(np.random.PCG64(_stream(seed, _TOKENS)))
    return rng.integers(0, vocab, size=(pool, batch, seq + 1),
                        dtype=np.int64)
