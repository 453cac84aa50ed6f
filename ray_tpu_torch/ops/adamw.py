"""AdamW's update as one CUDA kernel over many leaves (``csrc/adamw.cu``).

``train.train_step.AdamW.update`` sends CUDA leaves here. Its plain
version, ``AdamW.update_plain``, is the same arithmetic in PyTorch: CPU
tensors take it, and the card's tests hold the kernel to it bit for bit.

A launch takes up to ``MAX_LEAVES`` leaves, whose table travels in the
launch's parameters: the host copies nothing to the card and waits on
nothing. ``plan_launches`` cuts a longer list of leaves into launches.
``KERNEL.launches`` counts the launches, ``KERNEL.leaves`` the leaves they
updated.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from ray_tpu_torch.ops._build import CudaKernel

# Leaves a launch: csrc/adamw.cu's kMaxLeaves, the most whose table fits
# the 32,764 bytes of a launch's parameters.
MAX_LEAVES = 720
# The gradient types the kernel converts on load, as ``g.to(fp32)`` does.
G_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class AdamWKernel(CudaKernel):
    """``rtt_adamw`` with two counts, each raised only by a launch that
    returned no error: ``launches``, and ``leaves`` updated."""

    def __init__(self):
        super().__init__("adamw", "adamw", "rtt_adamw",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p])
        self.leaves = 0

    def __call__(self, count: int, *args) -> None:
        super().__call__(count, *args)
        self.leaves += count


KERNEL = AdamWKernel()


def plan_launches(sizes: Sequence[int],
                  max_leaves: int = MAX_LEAVES) -> List[List[int]]:
    """The leaves of each launch, as indices into ``sizes`` (their element
    counts): every leaf that holds an element, in order, at most
    ``max_leaves`` a launch. An empty leaf has nothing to update."""
    live = [i for i, n in enumerate(sizes) if n > 0]
    return [live[i:i + max_leaves] for i in range(0, len(live), max_leaves)]


def constants(lr: float, b1: float, b2: float, eps: float,
              weight_decay: float, bc1: float, bc2: float) -> np.ndarray:
    """The kernel's fp32 header (c1, b1, c2, b2, r1, r2, eps, wd, -lr), each
    as the plain version's CUDA ops take it: a Python scalar rounded to
    fp32, and a division by a scalar done as a product with its reciprocal
    rounded to fp32 (PyTorch's CUDA ``div`` by a CPU scalar; for the bias
    corrections, fp32 values, the fp32 quotient 1/bc)."""
    f = np.float32
    return np.array([1.0 - b1, b1, 1.0 - b2, b2, f(1.0) / f(bc1),
                     f(1.0) / f(bc2), eps, weight_decay, -lr], dtype=f)


def check_leaves(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                 nu: Sequence[torch.Tensor]) -> None:
    """Raise on what the kernel does not take: fp32 parameters and moments,
    gradients in fp32, bf16 or fp16, each leaf's four of one shape, all
    contiguous and on one device."""
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError(f"{len(params)} parameters, {len(grads)} gradients"
                         f", {len(mu)} and {len(nu)} moments")
    device = params[0].device if params else None
    f32 = torch.float32
    for i, (p, g, m, v) in enumerate(zip(params, grads, mu, nu)):
        leaf = (p, g, m, v)
        if p.dtype != f32 or m.dtype != f32 or v.dtype != f32:
            raise TypeError(f"leaf {i}: the AdamW kernel takes fp32 "
                            f"parameters and moments, got "
                            f"{[t.dtype for t in leaf]}")
        if g.dtype not in G_TYPES:
            raise TypeError(f"leaf {i}: the AdamW kernel takes gradients in "
                            f"{list(G_TYPES)}, got {g.dtype}")
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"leaf {i}: shapes differ "
                             f"{[tuple(t.shape) for t in leaf]}")
        if not device == p.device == g.device == m.device == v.device:
            raise ValueError(f"leaf {i}: the AdamW kernel's leaves must "
                             f"share one device, got "
                             f"{[str(t.device) for t in leaf]}")
        if not (p.is_contiguous() and g.is_contiguous()
                and m.is_contiguous() and v.is_contiguous()):
            raise ValueError(f"leaf {i}: the AdamW kernel takes contiguous "
                             f"tensors")

def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                 nu: Sequence[torch.Tensor], *, lr: float, b1: float,
                 b2: float, eps: float, weight_decay: float, bc1: float,
                 bc2: float) -> None:
    """One AdamW step on CUDA leaves, in place: ``params``, ``mu`` and
    ``nu`` updated from ``grads``, with the bias corrections ``bc1`` and
    ``bc2`` of this step. Raises on what the kernel does not take."""
    check_leaves(params, grads, mu, nu)
    if not params:
        return
    device = params[0].device
    if device.type != "cuda":
        raise ValueError(f"the AdamW kernel runs on CUDA, not on {device}")
    header = constants(lr, b1, b2, eps, weight_decay, bc1, bc2)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    for group in plan_launches([p.numel() for p in params]):
        table = np.array(
            [[params[i].data_ptr() for i in group],
             [grads[i].data_ptr() for i in group],
             [mu[i].data_ptr() for i in group],
             [nu[i].data_ptr() for i in group],
             [params[i].numel() for i in group],
             [G_TYPES[grads[i].dtype] for i in group]], dtype=np.int64)
        with torch.cuda.device(device):
            KERNEL(len(group), table.ctypes.data_as(ctypes.c_void_p),
                   header.ctypes.data_as(ctypes.c_void_p), stream)
