"""The yardstick: a configuration's leaves and their shapes, parameter
counts, model FLOPs a token, the attention kernels' least times, and the
card's published peaks. Frozen here so that no change to the program moves
it. Imports nothing but the standard library."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

# One NVIDIA H100 SXM (data sheet, dense rates): bf16/fp16 tensor cores,
# fp32 on the CUDA cores, and HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


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

    def leaves(self) -> Dict[str, Tuple[int, ...]]:
        return {n: s for block in self.blocks() for n, s in block}

    def n_params(self) -> int:
        return sum(_numel(s) for s in self.leaves().values())

    def n_matmul_params(self) -> int:
        """Parameters in weight products: every matrix but the embedding's
        lookup (the head counts; a tied head is the table)."""
        n = sum(_numel(s) for name, s in self.leaves().items()
                if len(s) == 2 and name != "embed.table")
        return n + (self.vocab * self.d_model if self.tied else 0)

    def model_flops_per_token(self, seq: int) -> float:
        """Training FLOPs a token: 6 P for the weight products (forward and
        backward) plus 6 L S d for attention's two products, the causal
        half counted; nothing recomputed is counted."""
        return (6.0 * self.n_matmul_params()
                + 6.0 * self.n_layers * seq * self.d_model)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


# The attention kernels: K1 the forward, K2 dQ, K3 dK and dV.
ATTN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def attn_bound_s(name: str, bh: int, s: int, d: int,
                 dtype: str = "bfloat16") -> Tuple[float, str]:
    """Least time of one causal launch over [bh, s, d]: each input byte
    read once and each output byte written once over HBM bandwidth,
    against the causal FLOPs over the tensor cores' peak. -> (seconds,
    "bytes" or "operations")."""
    el = BYTES[dtype]
    mat, row = bh * s * d * el, bh * s * 4
    pairs = bh * s * (s + 1) // 2
    work = {"flash_fwd": (4 * mat + row, 4 * d * pairs),
            "flash_bwd_dq": (5 * mat + 2 * row, 6 * d * pairs),
            "flash_bwd_dkv": (6 * mat + 2 * row, 8 * d * pairs)}
    nbytes, flops = work[name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
