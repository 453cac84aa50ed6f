"""GPT-style decoder LM in PyTorch: the counterpart of ``ray_tpu/models/gpt.py``.

Parameters keep the JAX names and ``[d_in, d_out]`` layouts
(``layers.<i>.attn.wq`` used as ``x @ w``, ``mlp.w_gate``, ``embed.table``,
``lm_head``, ``ln1.scale``), so ``models/convert.py`` moves a JAX param tree
in without transposes. Master weights are fp32 and are cast to
``cfg.dtype`` at each use, as in the JAX model. Attention goes through
``ray_tpu_torch.ops.attention.flash_attention`` (CUDA kernels on the card)
or ``mha_reference``.

Dense and MoE layers, remat ``full``, ``dots`` and ``none``; flash,
reference or ring attention.

Across devices (``train/train_step.py``) the model computes, on each rank,
its part of the global function of the JAX model, in the running step's
context (``parallel.mesh.data_parallel``):

- the batch group (data, fsdp, sequence) holds different tokens: the
  token count that normalises the loss and the expert counts of the MoE
  aux loss are summed over it (``parallel.mesh.all_sum``), and
  ``gpt_loss`` returns this rank's share of the whole batch's loss: the
  shares sum over the group to the JAX loss of the whole batch;
- a weight split over the tensor or expert axis (``parallel.sharding.
  shard_params``) is this rank's slice, and its block runs Megatron style
  (``parallel.tensor_parallel``): attention on local heads, the MLP on
  local d_ff, MoE on local experts and d_ff, the embedding as a masked
  lookup of local vocabulary rows, the head as local vocabulary columns
  with the cross-entropy's max, sum of exponentials and target logit
  reduced over the group. Which weights are split, and over which axis,
  the model asks its placement (``model.placement``); a weight that the
  block splits but that the rank holds whole (``moe/w_gate`` under
  ``tp``) is used in part, and its gradient summed over the axis
  (``take_part``);
- the sequence axis splits the tokens: each rank takes its S/n positions
  right after the input, with RoPE positions offset to match, and
  attention must be ``ring``.
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
from ray_tpu_torch.ops.attention import (flash_attention, mha_reference,
                                         ring_attention)
from ray_tpu_torch.parallel.mesh import (Axis, all_sum, current_step,
                                         data_parallel, step_axis, step_mesh)
from ray_tpu_torch.parallel.sharding import Placement
from ray_tpu_torch.parallel.tensor_parallel import (all_max, copy_to,
                                                    reduce_from, take_part)


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
    attention: str = "flash"          # flash | reference | ring
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
    if cfg.attention not in ("flash", "reference", "ring"):
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
    def __init__(self, cfg: GPTConfig, gen, index: int):
        super().__init__()
        self.cfg = cfg
        self.path = f"layers.{index}."     # its parameters' name prefix
        self.ln1 = _Norm(cfg.d_model, gen.device)
        self.ln2 = _Norm(cfg.d_model, gen.device)
        self.attn = _Attn(cfg, gen)
        if cfg.n_experts > 0:
            self.moe = _MoE(cfg, gen)
        else:
            self.mlp = _MLP(cfg, gen)

    def forward(self, x, positions, placement: Optional[Placement] = None):
        """-> (x, MoE stats or None), checkpointed by the remat policy.
        Inside the module's call, so that FSDP2's hooks gather the layer's
        weights around the forward and the backward's recompute."""
        policy = _remat_policy(self.cfg)
        if policy == "none":
            return _layer_fn(self, x, self.cfg, positions, placement)
        return checkpoint(
            _layer_in_step, current_step(), self, x, self.cfg, positions,
            placement, use_reentrant=False,
            **({"context_fn": _DOTS} if policy == "dots" else {}))


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
        self.layers = nn.ModuleList(_Layer(cfg, gen, i)
                                    for i in range(cfg.n_layers))

    def check_placement(self, placement: Placement) -> None:
        """Raise ValueError where ``placement`` (``parallel.sharding.
        shard_params``) splits a weight over the tensor or expert axis on
        another dim than its block splits (``_SPLIT_DIMS``), or attention
        inside a head. Whether the axes divide the dims, the placement
        checks itself."""
        names = [name for name, _ in self.named_parameters()]
        for name in names:
            if placement.split_dim(name, "pipeline") is not None:
                raise ValueError(f"{name}: split over 'pipeline', which "
                                 "splits the stacked layout only "
                                 "(parallel.pipeline.StackedGPT)")
            for axis, dims in _SPLIT_DIMS.items():
                dim = placement.split_dim(name, axis)
                want = dims.get(_block_key(name))
                if dim is not None and dim != want:
                    raise ValueError(
                        f"{name}: split over {axis!r} on dim {dim}, where "
                        "its block splits " + ("none" if want is None
                                               else f"dim {want}"))
        t = placement.mesh.shape["tensor"]
        split = any(placement.split_dim(name, "tensor") is not None
                    for name in names if ".attn." in name)
        if split and self.cfg.n_heads % t:
            raise ValueError(f"attn/wq: {self.cfg.n_heads} heads do not "
                             f"divide over the 'tensor' axis ({t})")

    def forward(self, tokens, targets=None):
        """tokens [B, S] -> ``gpt_forward``'s (logits, aux); given targets
        [B, S] (below 0: masked), ``gpt_loss``'s loss instead. Both run
        through the module's call, which FSDP2's hooks wrap."""
        x, aux = gpt_backbone(self, tokens)
        w_head, vocab = _head(self)
        if targets is None:
            return copy_to(x, vocab.group) @ w_head, aux
        targets = _local_positions(targets, step_axis("sequence"))
        b, s, d = x.shape
        mask = (targets >= 0).float()
        total, denom = chunked_xent(x.reshape(b * s, d), w_head,
                                    targets.reshape(b * s),
                                    mask.reshape(b * s), vocab=vocab)
        loss = total / torch.clamp_min(all_sum(denom), 1.0)
        if self.cfg.n_experts > 0:
            loss = loss + 0.01 * aux / self.cfg.n_layers
        return loss


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


# The dim of each weight that its block splits over the tensor or the
# expert axis (Megatron style), by its name under its layer or the model.
_SPLIT_DIMS = {
    "tensor": {"attn.wq": 1, "attn.wk": 1, "attn.wv": 1, "attn.wo": 0,
               "mlp.w_gate": 1, "mlp.w_up": 1, "mlp.w_down": 0,
               "moe.w_gate": 2, "moe.w_up": 2, "moe.w_down": 1,
               "embed.table": 0, "lm_head": 1},
    "expert": {"moe.w_gate": 0, "moe.w_up": 0, "moe.w_down": 0},
}


def _block_key(name: str) -> str:
    """A parameter's key in ``_SPLIT_DIMS``: its name under its layer."""
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "layers" else name


def _take(placement: Optional[Placement], axis: str, prefix: str,
          weights: Dict[str, torch.Tensor]) -> Tuple[list, Axis]:
    """The weights of one block (``{name under prefix: weight}``) at this
    rank's part of ``axis``. The block is split over the axis where the
    placement splits any of its weights: those are this rank's slices
    already, and a weight held whole is taken at this rank's part through
    ``take_part``. -> (weights, the axis; size 1 for a block that is not
    split, and without a placement)."""
    held = [placement is not None
            and placement.split_dim(prefix + name, axis) is not None
            for name in weights]
    if not any(held):
        return list(weights.values()), Axis()
    ax = placement.mesh.axis(axis)
    dims = _SPLIT_DIMS[axis]
    return [w if h else take_part(w, dims[name], ax.index, ax.size, ax.group)
            for (name, w), h in zip(weights.items(), held)], ax


def _attention_block(layer: _Layer, x, cfg: GPTConfig, positions,
                     placement: Optional[Placement] = None):
    b, s, d = x.shape
    hd, dt = cfg.head_dim, cfg.dtype
    attn = layer.attn
    (wq, wk, wv, wo), ax = _take(placement, "tensor", layer.path, {
        "attn.wq": attn.wq, "attn.wk": attn.wk, "attn.wv": attn.wv,
        "attn.wo": attn.wo})
    h = cfg.n_heads // ax.size
    x = copy_to(x, ax.group)

    def heads(w):
        return (x @ w.to(dt)).reshape(b, s, h, hd).transpose(1, 2)

    q = _rope(heads(wq), cfg.rope_theta, positions)
    k = _rope(heads(wk), cfg.rope_theta, positions)
    v = heads(wv)
    if cfg.attention == "ring":
        o = ring_attention(q, k, v, mesh=step_mesh(), causal=True)
    elif cfg.attention == "reference":
        o = mha_reference(q, k, v, causal=True)
    else:
        o = flash_attention(q, k, v, causal=True, block_q=cfg.flash_block_q,
                            block_k=cfg.flash_block_k)
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return reduce_from(o @ wo.to(dt), ax.group)


def _mlp_block(layer: _Layer, x, cfg: GPTConfig,
               placement: Optional[Placement] = None):
    dt = cfg.dtype
    m = layer.mlp
    (w_gate, w_up, w_down), ax = _take(placement, "tensor", layer.path, {
        "mlp.w_gate": m.w_gate, "mlp.w_up": m.w_up, "mlp.w_down": m.w_down})
    x = copy_to(x, ax.group)
    gate = x @ w_gate.to(dt)
    up = x @ w_up.to(dt)
    return reduce_from((F.silu(gate) * up) @ w_down.to(dt), ax.group)


def _route(moe: _MoE, x, cfg: GPTConfig):
    """The router: fp32 logits from ``x.float()``, softmax over experts,
    top-k, weights renormalised over the k. -> (probs [b,s,e], weights
    [b,s,k], expert indices [b,s,k])."""
    logits = x.float() @ moe.router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.expert_top_k, dim=-1)
    return probs, weights / weights.sum(dim=-1, keepdim=True), idx


def _moe_block(layer: _Layer, x, cfg: GPTConfig,
               placement: Optional[Placement] = None):
    """Top-k routed MoE with dense dispatch: every expert runs on every
    token and a one-hot combine [b,s,e] keeps the chosen k. Returns (y,
    stats): stats [2, e] holds, per expert, the tokens whose top-1 choice
    it is and the sum of its router probabilities (``_switch_aux``).

    Split over the expert axis (experts) and the tensor axis (d_ff), a rank
    runs its experts on its part of d_ff for every token it holds, and the
    outputs are summed over both axes. Routing is whole on every rank; the
    combine weights, like the input, come through ``copy_to``, so that their
    gradient, which each rank fills for its experts only, is whole again
    before it reaches the router."""
    dt = cfg.dtype
    m = layer.moe
    b, s, d = x.shape
    e = cfg.n_experts
    probs, weights, idx = _route(m, x, cfg)
    onehot = F.one_hot(idx, e).float()                         # [b,s,k,e]
    combine = torch.einsum("bsk,bske->bse", weights, onehot)
    (w_gate, w_up, w_down), ex = _take(placement, "expert", layer.path, {
        "moe.w_gate": m.w_gate, "moe.w_up": m.w_up, "moe.w_down": m.w_down})
    (w_gate, w_up, w_down), tx = _take(placement, "tensor", layer.path, {
        "moe.w_gate": w_gate, "moe.w_up": w_up, "moe.w_down": w_down})
    axes = [a for a, ax in (("expert", ex), ("tensor", tx)) if ax.size > 1]
    group = placement.mesh.axis(axes).group if axes else None
    el, fl = w_up.shape[0], w_up.shape[2]
    xe = copy_to(x, group)
    ce = copy_to(combine, group).narrow(-1, ex.index * el, el)

    def expert_in(w):
        # "bsd,edf->bsef" as one product with no batch dims (aten.mm, as
        # remat "dots" expects of a weight product).
        return (xe @ w.to(dt).permute(1, 0, 2).reshape(d, el * fl)).view(
            b, s, el, fl)

    act = F.silu(expert_in(w_gate)) * expert_in(w_up)
    out = torch.einsum("bsef,efd->bsed", act, w_down.to(dt))
    y = reduce_from(torch.einsum("bsed,bse->bsd", out.float(), ce), group)
    stats = torch.stack([onehot[:, :, 0].sum(dim=(0, 1)),
                         probs.sum(dim=(0, 1))])
    return y.to(dt), stats


def _switch_aux(stats, n_tokens: int, n_experts: int):
    """Switch load-balancing loss summed over layers: per layer, e times
    the sum over experts of density (the share of tokens whose top-1 is
    the expert; no gradient) times router_prob (its mean router
    probability). stats: [L, 2, e] from ``_moe_block``.

    Both means are over the whole batch: the counts are summed over the
    batch group of the running step, and the result is this rank's share
    (its tokens' probabilities against the global density), which sums
    over the group to the whole batch's aux loss."""
    n = all_sum(stats.new_tensor(float(n_tokens)))
    density = all_sum(stats[:, 0].detach()) / n
    router_prob = stats[:, 1] / n
    return n_experts * torch.sum(density * router_prob)


def _layer_fn(layer: _Layer, x, cfg: GPTConfig, positions,
              placement: Optional[Placement] = None):
    """-> (x, MoE stats or None); ``placement``: the model's (None: whole
    weights)."""
    h = x + _attention_block(
        layer, _rmsnorm(x, layer.ln1.scale, cfg.rmsnorm_eps), cfg, positions,
        placement)
    normed = _rmsnorm(h, layer.ln2.scale, cfg.rmsnorm_eps)
    if cfg.n_experts > 0:
        delta, stats = _moe_block(layer, normed, cfg, placement)
        return h + delta, stats
    return h + _mlp_block(layer, normed, cfg, placement), None


def _layer_in_step(step, layer: _Layer, x, cfg: GPTConfig, positions,
                   placement: Optional[Placement]):
    """``_layer_fn`` in the step context ``step``: the backward's recompute
    runs it on the autograd engine's thread under CUDA, which does not
    inherit the context of the step that the forward ran in."""
    with data_parallel(*step):
        return _layer_fn(layer, x, cfg, positions, placement)


# remat "dots", the counterpart of jax.checkpoint_policies.
# dots_with_no_batch_dims_saveable: the outputs of aten.mm (every weight
# product, the expert up-projections included) are saved; everything else
# is recomputed in backward: batched products (aten.bmm, such as the
# experts' down-projection with its batch dim e), norms, RoPE, SiLU and the
# flash-attention forward, whose kernel output is no product (JAX
# recomputes its pallas_call too).
_DOTS = functools.partial(create_selective_checkpoint_contexts,
                          [torch.ops.aten.mm.default])


def _local_positions(t, seq: Axis):
    """This rank's positions of ``t`` [B, S] on the sequence axis."""
    if seq.size == 1:
        return t
    if t.shape[1] % seq.size:
        raise ValueError(f"sequence length {t.shape[1]} does not divide over "
                         f"the 'sequence' axis ({seq.size})")
    n = t.shape[1] // seq.size
    return t[:, seq.index * n:(seq.index + 1) * n]


def _placement(model: GPT) -> Optional[Placement]:
    """The model's placement (``parallel.sharding.shard_params``); None for
    a model whose weights are whole."""
    return getattr(model, "placement", None)


def _embed(model: GPT, tokens):
    """Embedding rows of ``tokens`` in cfg.dtype; split over the vocabulary,
    a masked lookup of this rank's rows summed over the axis."""
    cfg = model.cfg
    (table,), ax = _take(_placement(model), "tensor", "",
                         {"embed.table": model.embed.table})
    if ax.size == 1:
        return table.to(cfg.dtype)[tokens]
    rows = table.shape[0]
    # Negative ids wrap, as they index the whole table.
    local = torch.remainder(tokens, cfg.vocab_size) - ax.index * rows
    own = (local >= 0) & (local < rows)
    x = table.to(cfg.dtype)[local.clamp(0, rows - 1)]
    return reduce_from(torch.where(own[..., None], x, 0.0), ax.group)


def gpt_backbone(model: GPT, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (final hidden states [B, S, D], aux): the MoE aux
    loss summed over layers (``_switch_aux``), 0 for dense layers. Split
    over the sequence axis, the hidden states are this rank's S/n
    positions."""
    cfg = model.cfg
    seq = step_axis("sequence")
    if seq.size > 1 and cfg.attention != "ring":
        raise ValueError(f"a 'sequence' axis of {seq.size} needs "
                         f"attention='ring', not {cfg.attention!r}")
    tokens = _local_positions(tokens, seq)
    b, s = tokens.shape
    x = _embed(model, tokens)
    positions = (seq.index * s + torch.arange(s, device=tokens.device)
                 )[None, :].expand(b, s)
    stats = []
    for layer in model.layers:
        x, st = layer(x, positions, _placement(model))
        if st is not None:
            stats.append(st)
    if stats:
        aux = _switch_aux(torch.stack(stats), b * s, cfg.n_experts)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _rmsnorm(x, model.final_norm.scale, cfg.rmsnorm_eps), aux


def _head(model: GPT) -> Tuple[torch.Tensor, Axis]:
    """(the head weight [D, V] in cfg.dtype, or this rank's vocabulary
    columns of it, and the axis that splits them)."""
    cfg = model.cfg
    if cfg.tie_embeddings:
        (table,), ax = _take(_placement(model), "tensor", "",
                             {"embed.table": model.embed.table})
        return table.to(cfg.dtype).t(), ax
    (w,), ax = _take(_placement(model), "tensor", "",
                     {"lm_head": model.lm_head})
    return w.to(cfg.dtype), ax


def gpt_forward(model: GPT, tokens):
    """tokens: [B, S] int -> (logits [B, S, vocab] in cfg.dtype, aux).
    Split over the tensor axis, the logits are this rank's vocabulary
    columns; over the sequence axis, its positions."""
    return model(tokens)


def _xent_chunk(xk, w_head, tk, mk, vocab: Axis):
    logits = (xk @ w_head).float()                      # [chunk, V]
    if vocab.group is None:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, 1, tk.clamp_min(0)[:, None])[:, 0]
    else:
        m = all_max(logits.detach().amax(dim=-1), vocab.group)
        lse = m + torch.log(reduce_from(
            torch.exp(logits - m[:, None]).sum(dim=-1), vocab.group))
        cols = logits.shape[1]
        local = tk - vocab.index * cols
        own = (local >= 0) & (local < cols)
        picked = torch.gather(logits, 1,
                              local.clamp(0, cols - 1)[:, None])[:, 0]
        picked = reduce_from(torch.where(own, picked, 0.0), vocab.group)
    nll = lse - picked
    return torch.sum(nll * mk), torch.sum(mk)


def chunked_xent(x, w_head, targets, mask, chunk_rows: int = 16384,
                 vocab: Axis = Axis()):
    """Next-token cross-entropy without the full [N, vocab] fp32 logits.

    Rows go in chunks under ``torch.utils.checkpoint``, so the backward
    recomputes each chunk's logits instead of saving them. x: [N, D]
    (model dtype), w_head: [D, V], targets: [N] int, mask: [N] fp32.
    Returns (sum_nll, sum_mask).

    ``vocab``: the axis that splits w_head's columns, this rank holding
    the vocab.index-th V/n of them: the max and the sum of exponentials are
    reduced over its group, and each target's logit comes from the rank
    that holds it."""
    n, d = x.shape
    x = copy_to(x, vocab.group)
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
                          vocab, use_reentrant=False)
        total = total + t
        denom = denom + m
    return total, denom


def gpt_loss(model: GPT, batch: Dict[str, torch.Tensor]):
    """batch: {"tokens": [B, S+1]} -> mean next-token cross-entropy, plus
    0.01 aux / n_layers for MoE; target positions below 0 are masked out.

    The mean is over the whole batch's unmasked targets: under a step over
    a mesh the count is summed over the batch group, and the loss is this
    rank's share (module doc)."""
    tokens = batch["tokens"]
    return model(tokens[:, :-1], tokens[:, 1:])


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
