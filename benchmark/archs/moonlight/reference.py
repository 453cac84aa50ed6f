"""The reference's layer of the DeepSeek-V3 decoder as Moonlight-16B-A3B
has it (``spec.py``), as ``harness/reference.py``'s runner calls it: plain
PyTorch in float32, written from the model's description
(``moonshotai/Moonlight-16B-A3B``'s config.json; DeepSeek-V3's report,
arXiv:2412.19437). Imports nothing of the program. ``mm`` is the runner's
matrix product (fp32, or the fp8 control's).

- Latent attention without a query low-rank projection: q = a wq, heads
  of q_nope + q_rope; [c, k_pe] = a wkv_a, c RMS-normed (eps 1e-6, the
  norm's default in DeepSeek's code); [k_nope, v] = c wkv_b; RoPE
  (half-split) on each q head's rotated part and on k_pe, which every
  head shares; causal softmax at 1/sqrt(d_qk); o wo.
- Dense MLPs in the first ``first_dense`` layers; then experts: sigmoid
  scores, the top k of the scores plus the selection bias chosen, their
  scores renormalised over the k and scaled; each of the ``held`` experts
  a SwiGLU on the tokens routed to it, weighted; the shared experts, one
  SwiGLU, on every token. What the experts this card does not hold would
  add is left out, as on the card.
- The sequence-wise balance loss, alpha sum_i f_i P_i per sequence (f_i =
  e / (k S) times the tokens whose k chosen include i, no gradient; P_i
  the sequence's mean of the scores normalised over the experts), averaged
  over the whole batch's sequences: the pass without gradients counts one
  a sequence, the runner sums the counts over rows and ranks, and the
  recompute divides by that sum.
- The selection bias, zeros at the first step, moves after each step by
  ``bias_rate``: up where the expert's load (the step's tokens whose k
  chosen include it, over the whole batch) was below the mean load, down
  where above (DeepSeek-V3's auxiliary-loss-free balancing). The pass
  without gradients counts each sequence's loads beside its one, and the
  recompute, given their sums, sets the next step's bias. The runner
  carries parameters alone from step to step, so each layer's bias is
  kept on the router weight that the runner hands the pass without
  gradients, which is the same tensor at every step of one reference
  (``_selection``)."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from archs.gpt.reference import head, rmsnorm  # noqa: F401
from archs.moonlight.spec import MoonlightSpec

LATENT_EPS = 1e-6
HEADS_AT_ONCE = 4      # softmax over [4, S, S] at a time: 1 GiB at S 8192

# Each router weight's selection state by its storage, for the recompute,
# whose leaves share the storage of the weights that the pass without
# gradients was handed.
_BY_STORAGE: Dict[int, dict] = {}


def _selection(router: torch.Tensor, recompute: bool) -> dict:
    """The selection state of the layer whose router weight is ``router``:
    {"bias": this step's, "next": the next step's once the recompute has
    set it}. A weight seen for the first time starts at zeros; the first
    pass of a step takes the bias the last step set."""
    if recompute:
        return _BY_STORAGE[router.data_ptr()]
    state = getattr(router, "_selection", None)
    if state is None:
        state = {"bias": router.new_zeros(router.shape[-1]), "next": None}
        router._selection = state
        _BY_STORAGE[router.data_ptr()] = state
    elif state["next"] is not None:
        state["bias"], state["next"] = state["next"], None
    return state


def prepare(spec: MoonlightSpec, seq: int, device):
    """RoPE's tables for the rotated width."""
    if spec.tied:
        raise ValueError("the reference has no tied head")
    half = spec.qk_rope // 2
    freqs = spec.rope_theta ** (-torch.arange(
        0, half, dtype=torch.float32, device=device) / half)
    angles = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        * freqs
    return torch.cos(angles), torch.sin(angles)


def rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(spec: MoonlightSpec, w: Dict[str, torch.Tensor], x, tables,
              mm):
    """x [S, d] plus the latent attention block's output."""
    s, _ = x.shape
    h, dn, dv, r = spec.n_heads, spec.qk_nope, spec.v_head, spec.kv_lora_rank
    cos, sin = tables
    a = rmsnorm(x, w["ln1.scale"], spec.norm_eps)
    q = mm(a, w["attn.wq"]).view(s, h, spec.d_qk).transpose(0, 1)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cos, sin)], dim=-1)
    kv = mm(a, w["attn.wkv_a"])
    c = rmsnorm(kv[:, :r], w["attn.kv_norm.scale"], LATENT_EPS)
    k_pe = rope(kv[:, r:], cos, sin)
    kvb = mm(c, w["attn.wkv_b"]).view(s, h, dn + dv).transpose(0, 1)
    k = torch.cat([kvb[..., :dn], k_pe.expand(h, s, spec.qk_rope)], dim=-1)
    v = kvb[..., dn:]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    outs = []
    for lo in range(0, h, HEADS_AT_ONCE):
        heads = slice(lo, lo + HEADS_AT_ONCE)
        scores = mm(q[heads], k[heads].transpose(-1, -2)) \
            * (1.0 / math.sqrt(spec.d_qk))
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")),
                              dim=-1)
        outs.append(mm(probs, v[heads]))
    o = torch.cat(outs).transpose(0, 1).reshape(s, h * dv)
    return x + mm(o, w["attn.wo"])


def swiglu(x, gate, up, down, mm):
    return mm(F.silu(mm(x, gate)) * mm(x, up), down)


def layer(spec: MoonlightSpec, i: int, w, x, ctx, mm, stats=None):
    h = attention(spec, w, x, ctx, mm)
    m = rmsnorm(h, w["ln2.scale"], spec.norm_eps)
    if i < spec.first_dense:
        return h + swiglu(m, w["mlp.w_gate"], w["mlp.w_up"], w["mlp.w_down"],
                          mm)
    selection = _selection(w["moe.router"], stats is not None)
    scores = torch.sigmoid(mm(m, w["moe.router"]))                 # [S, e]
    chosen = torch.topk(scores + selection["bias"], spec.top_k,
                        dim=-1).indices
    picked = torch.gather(scores, 1, chosen)
    weights = picked / (picked.sum(dim=-1, keepdim=True) + 1e-20) \
        * spec.routed_scale
    routed = torch.zeros_like(m)
    for j in range(spec.held):
        hit = chosen == j
        rows = hit.any(dim=-1)
        if rows.any():
            out = swiglu(m[rows], w["moe.w_gate"][j], w["moe.w_up"][j],
                         w["moe.w_down"][j], mm)
            routed[rows] += out * (weights * hit).sum(dim=-1)[rows][:, None]
    y = routed + swiglu(m, w["moe.shared.w_gate"], w["moe.shared.w_up"],
                        w["moe.shared.w_down"], mm)
    e, s = spec.n_experts, x.shape[0]
    load = F.one_hot(chosen, e).sum(dim=(0, 1)).float()
    if stats is None:
        return h + y, None, torch.cat([x.new_ones(1), load])
    loads = stats[1:]
    selection["next"] = selection["bias"] + spec.bias_rate * torch.sign(
        loads.mean() - loads)
    f = load * (e / (spec.top_k * s))
    p = (scores / scores.sum(dim=-1, keepdim=True)).mean(dim=0)
    return h + y, spec.aux_alpha * torch.sum(f * p) / stats[0], None
