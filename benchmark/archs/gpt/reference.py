"""The reference's layer and head of the dense GPT family, as
``harness/reference.py``'s runner calls them: plain PyTorch in float32,
written from the family's description (RoPE over the whole head, RMSNorm,
SwiGLU, causal softmax attention, next-token cross-entropy). Imports
nothing of the program. ``mm`` is the runner's matrix product (fp32, or
the fp8 control's)."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from archs.gpt.spec import ModelSpec


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope_tables(spec: ModelSpec, seq: int, device):
    half = spec.head_dim // 2
    freqs = spec.rope_theta ** (-torch.arange(
        0, half, dtype=torch.float32, device=device) / half)
    angles = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        * freqs
    return torch.cos(angles), torch.sin(angles)


def rope(x, cos, sin):
    """x: [H, S, D], the first half of each head rotated against the
    second."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(spec: ModelSpec, w: Dict[str, torch.Tensor], x, tables,
              mm=torch.matmul):
    """x [S, d] plus the attention block's output: RMSNorm (``ln1``),
    RoPE'd heads of ``attn.wq``/``wk``, ``attn.wv``, causal softmax,
    ``attn.wo``."""
    s, d = x.shape
    h, hd = spec.n_heads, spec.head_dim
    cos, sin = tables
    a = rmsnorm(x, w["ln1.scale"], spec.norm_eps)

    def heads(name):
        return mm(a, w[name]).view(s, h, hd).transpose(0, 1)

    q = rope(heads("attn.wq"), cos, sin)
    k = rope(heads("attn.wk"), cos, sin)
    v = heads("attn.wv")
    scores = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(probs, v).transpose(0, 1).reshape(s, d)
    return x + mm(o, w["attn.wo"])


def layer_forward(spec: ModelSpec, w: Dict[str, torch.Tensor], x, tables,
                  mm=torch.matmul):
    """One decoder layer on one sequence x [S, d]; ``w`` by the names under
    the layer (``attn.wq``, ``mlp.w_up``, ``ln1.scale``, ...)."""
    x = attention(spec, w, x, tables, mm)
    m = rmsnorm(x, w["ln2.scale"], spec.norm_eps)
    return x + mm(F.silu(mm(m, w["mlp.w_gate"])) * mm(m, w["mlp.w_up"]),
                  w["mlp.w_down"])


def prepare(spec: ModelSpec, seq: int, device):
    """What every layer of a step shares: RoPE's tables."""
    if spec.tied:
        raise ValueError("the reference has no tied head")
    return rope_tables(spec, seq, device)


def layer(spec: ModelSpec, i: int, w, x, ctx, mm, stats=None):
    return layer_forward(spec, w, x, ctx, mm)


def head(spec: ModelSpec, w: Dict[str, torch.Tensor], x, targets, mm):
    """The next-token loss of one sequence x [S, d], summed over its
    positions: the final RMSNorm, ``lm_head``, log-softmax."""
    logits = mm(rmsnorm(x, w["final_norm.scale"], spec.norm_eps),
                w["lm_head"])
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, 1, targets[:, None])[:, 0]
    return nll.sum()
