"""GPT-style decoder LM in PyTorch: the counterpart of ``ray_tpu/models/gpt.py``.

Parameters keep the JAX names and ``[d_in, d_out]`` layouts
(``layers.<i>.attn.wq`` used as ``x @ w``, ``mlp.w_gate``, ``embed.table``,
``lm_head``, ``ln1.scale``), so ``models/convert.py`` moves a JAX param tree
in without transposes. Master weights are fp32 and are cast to
``cfg.dtype`` at each use, as in the JAX model. Attention goes through
``ray_tpu_torch.ops.attention.flash_attention`` (CUDA kernels on the card)
or ``mha_reference``.

Dense and MoE layers, remat ``full``, ``dots`` and ``none``. Ring
attention raises ``NotImplementedError`` naming the ROADMAP item that
brings it.

Under a data-parallel step (``train/train_step.py``) the token count that
normalises the loss and the expert counts of the MoE aux loss are summed
over the data group (``parallel.mesh.all_sum``), and ``gpt_loss`` returns
this rank's share of the whole batch's loss: the shares sum over the group
to the loss that the JAX model gives for the whole batch.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.parallel.mesh import all_sum


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304           # GPT-2 vocab padded to a multiple of 128
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 1024
    dtype: Any = torch.bfloat16
    rope_theta: float = 10000.0
    rmsnorm_eps: float = 1e-5
    # MoE: 0 = dense MLPs; >0 = that many experts with top-k routing.
    n_experts: int = 0
    expert_top_k: int = 2
    remat: bool = True
    # None -> "full" if remat else "none". "full" recomputes each layer in
    # backward (torch.utils.checkpoint per layer); "dots" saves the weight
    # products' outputs and recomputes the rest (see _DOTS); "none" saves
    # everything.
    remat_policy: Optional[str] = None
    attention: str = "flash"          # flash | reference (ring: not yet)
    # The JAX kernel's blocks: decide the ragged fallback (see
    # ops/attention.flash_attention), not the CUDA kernels' tiles.
    flash_block_q: int = 128
    flash_block_k: int = 128
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def gpt2_small() -> "GPTConfig":
        return GPTConfig()

    @staticmethod
    def gpt2_medium() -> "GPTConfig":
        return GPTConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)

    @staticmethod
    def tiny() -> "GPTConfig":
        return GPTConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                         d_ff=256, max_seq=128)


def _remat_policy(cfg: GPTConfig) -> str:
    return cfg.remat_policy or ("full" if cfg.remat else "none")


def _check_supported(cfg: GPTConfig) -> None:
    policy = _remat_policy(cfg)
    if policy not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat_policy {policy!r} "
                         "(expected 'full' | 'dots' | 'none')")
    if cfg.attention == "ring":
        raise NotImplementedError(
            "attention='ring' is not ported yet: ROADMAP queue 1, item "
            "'ring_attention'")
    if cfg.attention not in ("flash", "reference"):
        raise ValueError(f"unknown attention {cfg.attention!r}")


def _dense(shape, scale: Optional[float], gen: torch.Generator):
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    return nn.Parameter(
        torch.randn(shape, generator=gen, device=gen.device) * scale)


class _Norm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))


class _Embed(nn.Module):
    def __init__(self, vocab: int, d: int, gen):
        super().__init__()
        self.table = _dense((vocab, d), 0.02, gen)


class _Attn(nn.Module):
    def __init__(self, cfg: GPTConfig, gen):
        super().__init__()
        d = cfg.d_model
        self.wq = _dense((d, d), None, gen)
        self.wk = _dense((d, d), None, gen)
        self.wv = _dense((d, d), None, gen)
        self.wo = _dense((d, d), 1.0 / math.sqrt(2 * cfg.n_layers * d), gen)


class _MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, gen):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.w_gate = _dense((d, ff), None, gen)
        self.w_up = _dense((d, ff), None, gen)
        self.w_down = _dense((ff, d), 1.0 / math.sqrt(2 * cfg.n_layers * ff),
                             gen)


class _MoE(nn.Module):
    def __init__(self, cfg: GPTConfig, gen):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _dense((d, e), 0.02, gen)
        self.w_gate = _dense((e, d, ff), None, gen)
        self.w_up = _dense((e, d, ff), None, gen)
        self.w_down = _dense((e, ff, d),
                             1.0 / math.sqrt(2 * cfg.n_layers * ff), gen)


class _Layer(nn.Module):
    def __init__(self, cfg: GPTConfig, gen):
        super().__init__()
        self.ln1 = _Norm(cfg.d_model, gen.device)
        self.ln2 = _Norm(cfg.d_model, gen.device)
        self.attn = _Attn(cfg, gen)
        if cfg.n_experts > 0:
            self.moe = _MoE(cfg, gen)
        else:
            self.mlp = _MLP(cfg, gen)


class GPT(nn.Module):
    """fp32 master weights under the JAX parameter names.

    ``forward(tokens)`` is ``gpt_forward``: [B, S] int -> (logits
    [B, S, vocab] in ``cfg.dtype``, aux)."""

    def __init__(self, cfg: GPTConfig, gen: torch.Generator):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = _Embed(cfg.vocab_size, cfg.d_model, gen)
        self.final_norm = _Norm(cfg.d_model, gen.device)
        if not cfg.tie_embeddings:
            self.lm_head = _dense((cfg.d_model, cfg.vocab_size), None, gen)
        self.layers = nn.ModuleList(_Layer(cfg, gen)
                                    for _ in range(cfg.n_layers))

    def forward(self, tokens):
        return gpt_forward(self, tokens)


def gpt_init(cfg: GPTConfig, device=None,
             generator: Optional[torch.Generator] = None) -> GPT:
    """Build the model (fp32 master weights) on ``device`` (default: the
    CUDA card; raises without one). Weights are drawn from ``generator``
    (default: seed 0 on the target device) with the JAX init's scales;
    the numbers differ from ``jax.random``'s, so parity tests load JAX
    weights through ``models.convert.params_from_jax``."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    return GPT(cfg, gen).to(dev)


def _rmsnorm(x, scale, eps: float):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _rope(x, theta: float, positions):
    """Rotary position embeddings, half-split; x: [B, H, S, D]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[:, :, None].float() * freqs         # [B, S, half]
    cos = torch.cos(angles)[:, None, :, :]
    sin = torch.sin(angles)[:, None, :, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _attention_block(layer: _Layer, x, cfg: GPTConfig, positions):
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    dt = cfg.dtype
    attn = layer.attn

    def heads(w):
        return (x @ w.to(dt)).reshape(b, s, h, hd).transpose(1, 2)

    q = _rope(heads(attn.wq), cfg.rope_theta, positions)
    k = _rope(heads(attn.wk), cfg.rope_theta, positions)
    v = heads(attn.wv)
    if cfg.attention == "reference":
        o = mha_reference(q, k, v, causal=True)
    else:
        o = flash_attention(q, k, v, causal=True, block_q=cfg.flash_block_q,
                            block_k=cfg.flash_block_k)
    o = o.transpose(1, 2).reshape(b, s, d)
    return o @ attn.wo.to(dt)


def _mlp_block(layer: _Layer, x, cfg: GPTConfig):
    dt = cfg.dtype
    m = layer.mlp
    gate = x @ m.w_gate.to(dt)
    up = x @ m.w_up.to(dt)
    return (F.silu(gate) * up) @ m.w_down.to(dt)


def _route(moe: _MoE, x, cfg: GPTConfig):
    """The router: fp32 logits from ``x.float()``, softmax over experts,
    top-k, weights renormalised over the k. -> (probs [b,s,e], weights
    [b,s,k], expert indices [b,s,k])."""
    logits = x.float() @ moe.router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.expert_top_k, dim=-1)
    return probs, weights / weights.sum(dim=-1, keepdim=True), idx


def _moe_block(layer: _Layer, x, cfg: GPTConfig):
    """Top-k routed MoE with dense dispatch: every expert runs on every
    token and a one-hot combine [b,s,e] keeps the chosen k. Returns (y,
    stats): stats [2, e] holds, per expert, the tokens whose top-1 choice
    it is and the sum of its router probabilities (``_switch_aux``)."""
    dt = cfg.dtype
    m = layer.moe
    b, s, d = x.shape
    e, ff = cfg.n_experts, cfg.d_ff
    probs, weights, idx = _route(m, x, cfg)
    onehot = F.one_hot(idx, e).float()                         # [b,s,k,e]
    combine = torch.einsum("bsk,bske->bse", weights, onehot)

    def expert_in(w):
        # "bsd,edf->bsef" as one product with no batch dims (aten.mm, as
        # remat "dots" expects of a weight product).
        return (x @ w.to(dt).permute(1, 0, 2).reshape(d, e * ff)).view(
            b, s, e, ff)

    act = F.silu(expert_in(m.w_gate)) * expert_in(m.w_up)
    out = torch.einsum("bsef,efd->bsed", act, m.w_down.to(dt))
    y = torch.einsum("bsed,bse->bsd", out.float(), combine)
    stats = torch.stack([onehot[:, :, 0].sum(dim=(0, 1)),
                         probs.sum(dim=(0, 1))])
    return y.to(dt), stats


def _switch_aux(stats, n_tokens: int, n_experts: int):
    """Switch load-balancing loss summed over layers: per layer, e times
    the sum over experts of density (the share of tokens whose top-1 is
    the expert; no gradient) times router_prob (its mean router
    probability). stats: [L, 2, e] from ``_moe_block``.

    Both means are over the whole batch: the counts are summed over the
    data group of the running step, and the result is this rank's share
    (its tokens' probabilities against the global density), which sums
    over the group to the whole batch's aux loss."""
    n = all_sum(stats.new_tensor(float(n_tokens)))
    density = all_sum(stats[:, 0].detach()) / n
    router_prob = stats[:, 1] / n
    return n_experts * torch.sum(density * router_prob)


def _layer_fn(layer: _Layer, x, cfg: GPTConfig, positions):
    """-> (x, MoE stats or None)."""
    h = x + _attention_block(
        layer, _rmsnorm(x, layer.ln1.scale, cfg.rmsnorm_eps), cfg, positions)
    normed = _rmsnorm(h, layer.ln2.scale, cfg.rmsnorm_eps)
    if cfg.n_experts > 0:
        delta, stats = _moe_block(layer, normed, cfg)
        return h + delta, stats
    return h + _mlp_block(layer, normed, cfg), None


# remat "dots", the counterpart of jax.checkpoint_policies.
# dots_with_no_batch_dims_saveable: the outputs of aten.mm (every weight
# product, the expert up-projections included) are saved; everything else
# is recomputed in backward: batched products (aten.bmm, such as the
# experts' down-projection with its batch dim e), norms, RoPE, SiLU and the
# flash-attention forward, whose kernel output is no product (JAX
# recomputes its pallas_call too).
_DOTS = functools.partial(create_selective_checkpoint_contexts,
                          [torch.ops.aten.mm.default])


def gpt_backbone(model: GPT, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (final hidden states [B, S, D], aux): the MoE aux
    loss summed over layers (``_switch_aux``), 0 for dense layers."""
    cfg = model.cfg
    b, s = tokens.shape
    x = model.embed.table.to(cfg.dtype)[tokens]
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    policy = _remat_policy(cfg)
    stats = []
    for layer in model.layers:
        if policy == "none":
            x, st = _layer_fn(layer, x, cfg, positions)
        else:
            x, st = checkpoint(
                _layer_fn, layer, x, cfg, positions, use_reentrant=False,
                **({"context_fn": _DOTS} if policy == "dots" else {}))
        if st is not None:
            stats.append(st)
    if stats:
        aux = _switch_aux(torch.stack(stats), b * s, cfg.n_experts)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _rmsnorm(x, model.final_norm.scale, cfg.rmsnorm_eps), aux


def _head_weight(model: GPT):
    dt = model.cfg.dtype
    if model.cfg.tie_embeddings:
        return model.embed.table.to(dt).t()
    return model.lm_head.to(dt)


def gpt_forward(model: GPT, tokens):
    """tokens: [B, S] int -> (logits [B, S, vocab] in cfg.dtype, aux)."""
    x, aux = gpt_backbone(model, tokens)
    return x @ _head_weight(model), aux


def _xent_chunk(xk, w_head, tk, mk):
    logits = (xk @ w_head).float()                      # [chunk, V]
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, 1, tk.clamp_min(0)[:, None])[:, 0]
    nll = lse - picked
    return torch.sum(nll * mk), torch.sum(mk)


def chunked_xent(x, w_head, targets, mask, chunk_rows: int = 16384):
    """Next-token cross-entropy without the full [N, vocab] fp32 logits.

    Rows go in chunks under ``torch.utils.checkpoint``, so the backward
    recomputes each chunk's logits instead of saving them. x: [N, D]
    (model dtype), w_head: [D, V], targets: [N] int, mask: [N] fp32.
    Returns (sum_nll, sum_mask)."""
    n, d = x.shape
    # Never chunk coarser than the batch itself (see the JAX version).
    chunk_rows = min(chunk_rows, max(128, n))
    pad = (-n) % chunk_rows
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    denom = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, n + pad, chunk_rows):
        sl = slice(start, start + chunk_rows)
        t, m = checkpoint(_xent_chunk, x[sl], w_head, targets[sl], mask[sl],
                          use_reentrant=False)
        total = total + t
        denom = denom + m
    return total, denom


def gpt_loss(model: GPT, batch: Dict[str, torch.Tensor]):
    """batch: {"tokens": [B, S+1]} -> mean next-token cross-entropy, plus
    0.01 aux / n_layers for MoE; target positions below 0 are masked out.

    The mean is over the whole batch's unmasked targets: under a
    data-parallel step the count is summed over the data group, and the
    loss is this rank's share (module doc)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x, aux = gpt_backbone(model, inputs)
    b, s, d = x.shape
    mask = (targets >= 0).float()
    total, denom = chunked_xent(x.reshape(b * s, d), _head_weight(model),
                                targets.reshape(b * s), mask.reshape(b * s))
    loss = total / torch.clamp_min(all_sum(denom), 1.0)
    if model.cfg.n_experts > 0:
        loss = loss + 0.01 * aux / model.cfg.n_layers
    return loss


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
