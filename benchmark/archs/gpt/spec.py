"""The yardstick of the dense GPT family: a configuration's leaves and
their shapes, the scales they are drawn at, parameter counts, model FLOPs
a token and the shapes of its attention calls. Frozen here so that no
change to the program moves it. Imports nothing but the standard
library."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class ModelSpec:
    """The widths of a decoder in the port's GPT family (RoPE over the whole
    head, RMSNorm, SwiGLU, untied head), read from a configuration file in
    Hugging Face's key names."""
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    rope_theta: float
    norm_eps: float
    tied: bool

    @staticmethod
    def from_config(cfg: dict) -> "ModelSpec":
        return ModelSpec(
            vocab=int(cfg["vocab_size"]), d_model=int(cfg["hidden_size"]),
            n_layers=int(cfg["num_hidden_layers"]),
            n_heads=int(cfg["num_attention_heads"]),
            d_ff=int(cfg["intermediate_size"]),
            rope_theta=float(cfg.get("rope_theta", 10000.0)),
            norm_eps=float(cfg.get("rms_norm_eps",
                                   cfg.get("layer_norm_eps", 1e-5))),
            tied=bool(cfg.get("tie_word_embeddings", False)))

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def blocks(self) -> List[List[Tuple[str, Tuple[int, ...]]]]:
        """The leaves by block, under the port's parameter names: block 0
        the embedding, the final norm and the head; block i + 1 layer i."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        outer = [("embed.table", (v, d)), ("final_norm.scale", (d,))]
        if not self.tied:
            outer.append(("lm_head", (d, v)))
        out = [outer]
        for i in range(self.n_layers):
            p = f"layers.{i}."
            out.append([(p + "ln1.scale", (d,)), (p + "ln2.scale", (d,)),
                        (p + "attn.wq", (d, d)), (p + "attn.wk", (d, d)),
                        (p + "attn.wv", (d, d)), (p + "attn.wo", (d, d)),
                        (p + "mlp.w_gate", (d, ff)), (p + "mlp.w_up", (d, ff)),
                        (p + "mlp.w_down", (ff, d))])
        return out

    def init_scale(self, name: str, shape) -> float:
        """The draw's standard deviation: 1/sqrt(fan-in), the embedding
        0.02, the residual outputs (attention's and the MLP's last
        products) scaled down by 1/sqrt(2 L). Norm scales start at 1 (0
        here: not drawn)."""
        if len(shape) == 1:
            return 0.0
        if name == "embed.table":
            return 0.02
        if name.endswith(("attn.wo", "mlp.w_down")):
            return 1.0 / math.sqrt(2 * self.n_layers * shape[0])
        return 1.0 / math.sqrt(shape[0])

    def leaves(self) -> Dict[str, Tuple[int, ...]]:
        return {n: s for block in self.blocks() for n, s in block}

    def n_params(self) -> int:
        return sum(math.prod(s) for s in self.leaves().values())

    def n_matmul_params(self) -> int:
        """Parameters in weight products: every matrix but the embedding's
        lookup (the head counts; a tied head is the table)."""
        n = sum(math.prod(s) for name, s in self.leaves().items()
                if len(s) == 2 and name != "embed.table")
        return n + (self.vocab * self.d_model if self.tied else 0)

    def model_flops_per_token(self, seq: int) -> float:
        """Training FLOPs a token: 6 P for the weight products (forward and
        backward) plus 6 L S d for attention's two products, the causal
        half counted; nothing recomputed is counted."""
        return (6.0 * self.n_matmul_params()
                + 6.0 * self.n_layers * seq * self.d_model)

    def attn_shapes(self, traffic: dict) -> List[tuple]:
        """(share, B·H, S, d_qk, d_v) of each kind of attention call a step
        makes on one rank: here one kind, every layer's."""
        d = self.head_dim
        return [(1, traffic["batch_per_rank"] * self.n_heads,
                 traffic["seq"], d, d)]


from_config = ModelSpec.from_config
