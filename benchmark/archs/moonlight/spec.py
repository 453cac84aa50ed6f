"""The yardstick of the DeepSeek-V3 decoder on one card of an
expert-parallel deployment: a configuration's leaves and their shapes, the
scales they are drawn at, parameter counts, model FLOPs a token and the
shapes of its attention calls. Frozen here so that no change to the
program moves it. Imports nothing but the standard library.

The configuration's ``n_routed_experts`` is the experts this card holds
(the first of them); the router keeps the published count
(``published.n_routed_experts``) and its experts per token."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class MoonlightSpec:
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int                 # the dense leading layers' MLP
    rope_theta: float
    norm_eps: float
    tied: bool
    kv_lora_rank: int
    qk_nope: int
    qk_rope: int
    v_head: int
    n_experts: int            # routed over (the published count)
    held: int                 # of which this card holds the first ``held``
    top_k: int
    moe_d_ff: int
    n_shared: int
    first_dense: int
    routed_scale: float
    aux_alpha: float
    bias_rate: float          # the selection bias's update speed a step

    @staticmethod
    def from_config(cfg: dict) -> "MoonlightSpec":
        return MoonlightSpec(
            vocab=int(cfg["vocab_size"]), d_model=int(cfg["hidden_size"]),
            n_layers=int(cfg["num_hidden_layers"]),
            n_heads=int(cfg["num_attention_heads"]),
            d_ff=int(cfg["intermediate_size"]),
            rope_theta=float(cfg["rope_theta"]),
            norm_eps=float(cfg["rms_norm_eps"]),
            tied=bool(cfg["tie_word_embeddings"]),
            kv_lora_rank=int(cfg["kv_lora_rank"]),
            qk_nope=int(cfg["qk_nope_head_dim"]),
            qk_rope=int(cfg["qk_rope_head_dim"]),
            v_head=int(cfg["v_head_dim"]),
            n_experts=int(cfg["published"]["n_routed_experts"]),
            held=int(cfg["n_routed_experts"]),
            top_k=int(cfg["num_experts_per_tok"]),
            moe_d_ff=int(cfg["moe_intermediate_size"]),
            n_shared=int(cfg["n_shared_experts"]),
            first_dense=int(cfg["first_k_dense_replace"]),
            routed_scale=float(cfg["routed_scaling_factor"]),
            aux_alpha=float(cfg["aux_loss_alpha"]),
            bias_rate=float(cfg["bias_update_speed"]))

    @property
    def d_qk(self) -> int:
        return self.qk_nope + self.qk_rope

    def blocks(self) -> List[List[Tuple[str, Tuple[int, ...]]]]:
        """The leaves by block, under the port's parameter names: block 0
        the embedding, the final norm and the head; block i + 1 layer i,
        its MLA, then a dense MLP (below ``first_dense``) or its router,
        held experts and shared experts."""
        d, v, h, r = self.d_model, self.vocab, self.n_heads, self.kv_lora_rank
        outer = [("embed.table", (v, d)), ("final_norm.scale", (d,))]
        if not self.tied:
            outer.append(("lm_head", (d, v)))
        out = [outer]
        ff, e, sh = self.moe_d_ff, self.held, self.n_shared * self.moe_d_ff
        for i in range(self.n_layers):
            p = f"layers.{i}."
            block = [(p + "ln1.scale", (d,)), (p + "ln2.scale", (d,)),
                     (p + "attn.wq", (d, h * self.d_qk)),
                     (p + "attn.wkv_a", (d, r + self.qk_rope)),
                     (p + "attn.kv_norm.scale", (r,)),
                     (p + "attn.wkv_b", (r, h * (self.qk_nope + self.v_head))),
                     (p + "attn.wo", (h * self.v_head, d))]
            if i < self.first_dense:
                block += [(p + "mlp.w_gate", (d, self.d_ff)),
                          (p + "mlp.w_up", (d, self.d_ff)),
                          (p + "mlp.w_down", (self.d_ff, d))]
            else:
                block += [(p + "moe.router", (d, self.n_experts)),
                          (p + "moe.w_gate", (e, d, ff)),
                          (p + "moe.w_up", (e, d, ff)),
                          (p + "moe.w_down", (e, ff, d)),
                          (p + "moe.shared.w_gate", (d, sh)),
                          (p + "moe.shared.w_up", (d, sh)),
                          (p + "moe.shared.w_down", (sh, d))]
            out.append(block)
        return out

    def init_scale(self, name: str, shape) -> float:
        """The draw's standard deviation: 1/sqrt(fan-in), the embedding and
        the router 0.02, the residual outputs (attention's and every MLP's
        last products) scaled down by 1/sqrt(2 L). Norm scales start at 1
        (0 here: not drawn)."""
        if len(shape) == 1:
            return 0.0
        if name == "embed.table" or name.endswith("moe.router"):
            return 0.02
        if name.endswith(("attn.wo", "w_down")):
            return 1.0 / math.sqrt(2 * self.n_layers * shape[-2])
        return 1.0 / math.sqrt(shape[-2])

    def leaves(self) -> Dict[str, Tuple[int, ...]]:
        return {n: s for block in self.blocks() for n, s in block}

    def n_params(self) -> int:
        return sum(math.prod(s) for s in self.leaves().values())

    def model_flops_per_token(self, seq: int) -> float:
        """Training FLOPs a token: 6 x the parameters in weight products
        (every matrix but the embedding's lookup; of the held experts the
        share a token is routed to, k of the experts routed over; the
        shared experts and the router whole) plus attention's two products
        at the causal half, 3 L S H (d_qk + d_v); nothing recomputed."""
        routed = self.top_k / self.n_experts
        n = 0.0
        for name, s in self.leaves().items():
            if len(s) == 1 or name == "embed.table":
                continue
            share = routed if ".moe.w_" in name else 1.0
            n += share * math.prod(s)
        return (6.0 * n + 3.0 * self.n_layers * seq * self.n_heads
                * (self.d_qk + self.v_head))

    def attn_shapes(self, traffic: dict) -> List[tuple]:
        """(share, B·H, S, d_qk, d_v): one kind of call, every layer's."""
        return [(1, traffic["batch_per_rank"] * self.n_heads,
                 traffic["seq"], self.d_qk, self.v_head)]


from_config = MoonlightSpec.from_config
