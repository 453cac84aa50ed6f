"""The collectives of a model split over the tensor and expert axes.

Megatron's pair of autograd functions, over a process group:

    copy_to(x, group)      f: identity forward, all-reduce of the gradient
    reduce_from(x, group)  g: all-reduce forward, identity backward

A block whose weights are split over a group takes its input through
``copy_to`` (each rank's partial input gradient is summed, so the input's
gradient is whole again) and its output through ``reduce_from`` (each
rank's partial output is summed). ``take_part`` is ``copy_to`` for a weight
that every rank of the group holds whole but uses only in part: its
gradient, which each rank fills only in its own part, is summed over the
group. A group of None is one rank: every function is then the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """f: ``x`` forward; the gradient summed over ``group`` backward."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """g: ``x`` summed over ``group`` forward; the gradient as is
    backward."""
    return x if group is None else _ReduceFrom.apply(x, group)


def take_part(w: torch.Tensor, dim: int, index: int, size: int,
              group) -> torch.Tensor:
    """Part ``index`` of ``size`` equal parts of ``w`` along ``dim``, for a
    weight that every rank of ``group`` holds whole; its gradient is summed
    over the group, so that each rank's holds every part."""
    n = w.shape[dim] // size
    return copy_to(w, group).narrow(dim, index * n, n)


@torch.no_grad()
def all_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group`` (no gradient)."""
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
