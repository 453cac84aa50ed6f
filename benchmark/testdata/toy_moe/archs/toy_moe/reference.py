"""The reference's layer of the routed-expert GPT (``spec.py``): the dense
family's attention, then a mixture of SwiGLU experts, top-k of the
router's softmax with the chosen weights renormalised, and the Switch
load-balancing loss 0.01 / L times e times the sum over experts of the
share of the batch's tokens whose first choice it is (no gradient) times
its mean router probability. Plain PyTorch, fp32, nothing of the program.
The shares are over the whole batch: the pass without gradients gives
each sequence's counts, the runner sums them over rows and ranks, and the
recompute takes that sum."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from archs.gpt.reference import attention, head, prepare, rmsnorm  # noqa: F401

AUX_WEIGHT = 0.01


def layer(spec, i: int, w, x, ctx, mm, stats=None):
    h = attention(spec, w, x, ctx, mm)
    m = rmsnorm(h, w["ln2.scale"], spec.norm_eps)
    e = spec.n_experts
    probs = torch.softmax(mm(m, w["moe.router"]), dim=-1)         # [S, e]
    top, idx = torch.topk(probs, spec.top_k, dim=-1)
    gates = torch.zeros_like(probs).scatter(
        -1, idx, top / top.sum(dim=-1, keepdim=True))
    y = sum(mm(F.silu(mm(m, w["moe.w_gate"][j])) * mm(m, w["moe.w_up"][j]),
               w["moe.w_down"][j]) * gates[:, j:j + 1] for j in range(e))
    if stats is None:
        first = F.one_hot(idx[:, 0], e).sum(dim=0).float()
        return h + y, None, torch.cat([first, first.new_tensor([x.shape[0]])])
    n = stats[e]
    term = AUX_WEIGHT / spec.n_layers * e * torch.sum(
        stats[:e] / n * probs.sum(dim=0) / n)
    return h + y, term, None
