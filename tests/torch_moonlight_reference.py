"""A plain reference of the DeepSeek-V3 decoder as Moonlight-16B-A3B has it,
written from its description (``moonshotai/Moonlight-16B-A3B``'s
config.json, DeepSeek-V3's report, arXiv:2412.19437), for the port's
CPU tests: plain PyTorch in float32, one operation after another, no
kernels. It imports nothing of the port and nothing of JAX.

- Latent attention without a query low-rank projection: q = x wq, heads
  of nope + rope; [c, k_pe] = x wkv_a, c RMS-normed (eps 1e-6); [k_nope,
  v] = c wkv_b; RoPE (half-split) on each q head's last ``rope`` and on
  k_pe, which every head shares; causal softmax at 1/sqrt(nope + rope); o
  wo.
- Experts: sigmoid scores of x router; the k largest of scores + bias
  chosen; their scores renormalised over the k and scaled; of the experts
  [first, first + count) whose weights are given, each a SwiGLU on the
  tokens routed to it, weighted; plus the shared experts, one SwiGLU on
  every token; dense MLPs in the leading layers.
- The selection bias after a train step (``moved``): each expert's moves
  by the rate, up where its load (the step's tokens whose k chosen
  include it) was below the mean load and down where above
  (DeepSeek-V3's auxiliary-loss-free balancing).
- The loss: the mean next-token cross-entropy plus alpha times, summed
  over layers, the mean over sequences of sum_i f_i P_i (f_i = e / (k T)
  times the tokens whose k chosen include i, without gradient; P_i the
  sequence's mean of the scores normalised over the experts).

Weights are a dict under the port's parameter names; ``bias`` a dict of
each expert layer's selection bias [e]."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

LATENT_EPS = 1e-6


@dataclass(frozen=True)
class Widths:
    vocab: int
    d: int
    layers: int
    heads: int
    d_ff: int
    nope: int
    rope: int
    v: int
    latent: int
    experts: int
    top_k: int
    expert_ff: int
    shared: int
    first_dense: int
    held: Tuple[int, int]
    scale: float
    alpha: float
    theta: float = 10000.0
    eps: float = 1e-5


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta: float):
    """x [..., S, D]: the first half of each vector rotated against the
    second by position."""
    s, dim = x.shape[-2], x.shape[-1]
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32) / half)
    ang = torch.arange(s, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mla(c: Widths, w: Dict[str, torch.Tensor], x):
    """x [B, S, d] (normed) -> the attention block's output [B, S, d];
    ``w`` by the names under the layer."""
    b, s, _ = x.shape
    h = c.heads
    q = (x @ w["attn.wq"]).view(b, s, h, c.nope + c.rope).transpose(1, 2)
    q = torch.cat([q[..., :c.nope], rope(q[..., c.nope:], c.theta)], dim=-1)
    kv = x @ w["attn.wkv_a"]
    lat = rmsnorm(kv[..., :c.latent], w["attn.kv_norm.scale"], LATENT_EPS)
    k_pe = rope(kv[..., c.latent:], c.theta)                  # [B, S, rope]
    kvb = (lat @ w["attn.wkv_b"]).view(b, s, h, c.nope + c.v).transpose(1, 2)
    k = torch.cat([kvb[..., :c.nope],
                   k_pe[:, None].expand(b, h, s, c.rope)], dim=-1)
    v = kvb[..., c.nope:]
    logits = q @ k.transpose(-1, -2) / math.sqrt(c.nope + c.rope)
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    p = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
    o = (p @ v).transpose(1, 2).reshape(b, s, h * c.v)
    return o @ w["attn.wo"]


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def route(c: Widths, router, bias, x):
    """-> (scores [..., e], weights [..., k], chosen [..., k])."""
    scores = torch.sigmoid(x @ router)
    chosen = torch.topk(scores + bias, c.top_k, dim=-1).indices
    picked = torch.gather(scores, -1, chosen)
    weights = picked / (picked.sum(dim=-1, keepdim=True) + 1e-20) * c.scale
    return scores, weights, chosen


def experts(c: Widths, w: Dict[str, torch.Tensor], bias, x,
            held: Optional[Tuple[int, int]] = None, shared: bool = True):
    """x [B, S, d] (normed) -> (the expert layer's output [B, S, d], its
    balance term without alpha: the mean over the B sequences of sum_i f_i
    P_i). ``held``: (first, count) of the experts given in ``w``
    (``c.held`` by default); ``shared``: with the shared experts."""
    first, count = c.held if held is None else held
    scores, weights, chosen = route(c, w["moe.router"], bias, x)
    y = torch.zeros_like(x)
    for j in range(count):
        hit = chosen == first + j                              # [B, S, k]
        rows = hit.any(dim=-1)
        if not rows.any():
            continue
        out = swiglu(x[rows], w["moe.w_gate"][j], w["moe.w_up"][j],
                     w["moe.w_down"][j])
        y[rows] += out * (weights * hit).sum(dim=-1)[rows][:, None]
    if shared:
        y = y + swiglu(x, w["moe.shared.w_gate"], w["moe.shared.w_up"],
                       w["moe.shared.w_down"])
    s, e = x.shape[1], c.experts
    counts = F.one_hot(chosen, e).sum(dim=(1, 2)).float()      # [B, e]
    f = counts * e / (c.top_k * s)
    p = (scores / scores.sum(dim=-1, keepdim=True)).mean(dim=1)
    return y, (f * p).sum(dim=-1).mean()


def layer(c: Widths, i: int, w: Dict[str, torch.Tensor], bias, x):
    """Layer i on x [B, S, d] -> (its output, its balance term or 0)."""
    h = x + mla(c, w, rmsnorm(x, w["ln1.scale"], c.eps))
    m = rmsnorm(h, w["ln2.scale"], c.eps)
    if i < c.first_dense:
        return h + swiglu(m, w["mlp.w_gate"], w["mlp.w_up"],
                          w["mlp.w_down"]), x.new_zeros(())
    y, term = experts(c, w, bias, m)
    return h + y, term


def loss(c: Widths, params: Dict[str, torch.Tensor],
         biases: Dict[int, torch.Tensor], tokens):
    """tokens [B, S + 1] -> (the loss, the balance term without alpha)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = params["embed.table"][inputs]
    aux = x.new_zeros(())
    for i in range(c.layers):
        p = f"layers.{i}."
        w = {n[len(p):]: t for n, t in params.items() if n.startswith(p)}
        x, term = layer(c, i, w, biases.get(i), x)
        aux = aux + term
    logits = rmsnorm(x, params["final_norm.scale"], c.eps) @ \
        params["lm_head"]
    xent = F.cross_entropy(logits.reshape(-1, c.vocab), targets.reshape(-1))
    return xent + c.alpha * aux, aux


@torch.no_grad()
def loads(c: Widths, params: Dict[str, torch.Tensor],
          biases: Dict[int, torch.Tensor], tokens) -> Dict[int, torch.Tensor]:
    """Each expert layer's load over the batch tokens [B, S + 1]: [e], the
    tokens whose k chosen include each expert."""
    x = params["embed.table"][tokens[:, :-1]]
    out = {}
    for i in range(c.layers):
        p = f"layers.{i}."
        w = {n[len(p):]: t for n, t in params.items() if n.startswith(p)}
        if i >= c.first_dense:
            m = rmsnorm(x + mla(c, w, rmsnorm(x, w["ln1.scale"], c.eps)),
                        w["ln2.scale"], c.eps)
            chosen = route(c, w["moe.router"], biases[i], m)[2]
            out[i] = F.one_hot(chosen, c.experts).sum(dim=(0, 1, 2)).float()
        x = layer(c, i, w, biases.get(i), x)[0]
    return out


def moved(bias, load, rate: float):
    """The selection bias after a step whose load was ``load``."""
    return bias + rate * torch.sign(load.mean() - load)
