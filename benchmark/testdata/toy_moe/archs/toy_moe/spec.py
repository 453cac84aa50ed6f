"""The GPT family with a routed mixture of SwiGLU experts in place of each
layer's MLP: the router [d, e] and the experts' [e, d, ff], [e, d, ff]
and [e, ff, d]. Imports nothing but the standard library (and the dense
family's spec, which does the same)."""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

from archs.gpt.spec import ModelSpec


@dataclass(frozen=True)
class MoESpec(ModelSpec):
    n_experts: int = 0
    top_k: int = 0

    @staticmethod
    def from_config(cfg: dict) -> "MoESpec":
        dense = ModelSpec.from_config(cfg)
        return MoESpec(**{f.name: getattr(dense, f.name)
                          for f in fields(ModelSpec)},
                       n_experts=int(cfg["num_local_experts"]),
                       top_k=int(cfg["num_experts_per_tok"]))

    def blocks(self):
        d, ff, e = self.d_model, self.d_ff, self.n_experts
        out = super().blocks()
        for i, block in enumerate(out[1:]):
            p = f"layers.{i}."
            block[:] = [(n, s) for n, s in block if ".mlp." not in n] + [
                (p + "moe.router", (d, e)), (p + "moe.w_gate", (e, d, ff)),
                (p + "moe.w_up", (e, d, ff)), (p + "moe.w_down", (e, ff, d))]
        return out

    def init_scale(self, name: str, shape) -> float:
        if name.endswith("moe.router"):
            return 0.02
        if name.endswith("moe.w_down"):
            return 1.0 / math.sqrt(2 * self.n_layers * shape[-2])
        return super().init_scale(name, shape[-2:])

    def model_flops_per_token(self, seq: int) -> float:
        """The dense count with each layer's experts at the share that a
        token is routed to (k of e); the router counts whole."""
        experts = 3 * self.d_model * self.d_ff * self.n_experts
        routed = experts * self.top_k / self.n_experts
        dense = self.n_matmul_params() - self.n_layers * experts
        return (6.0 * (dense + self.n_layers * routed)
                + 6.0 * self.n_layers * seq * self.d_model)

    def n_matmul_params(self) -> int:
        return super().n_matmul_params() + self.n_layers * (
            3 * self.d_model * self.d_ff * self.n_experts)


from_config = MoESpec.from_config
