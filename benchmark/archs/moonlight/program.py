"""The DeepSeek-V3 decoder in the port: ``ray_tpu_torch.models``'s GPT with
latent attention, sigmoid routing over the published experts with the
spec's first ``held`` of them held and the selection bias moved after each
step, shared experts and dense leading layers, at the traffic's sequence,
type and remat policy, on the flash attention kernels; its loss adds the
sequence-wise balance loss. The sparse expert layer's counters are the
architecture's launches."""

from __future__ import annotations

import dataclasses

from ray_tpu_torch.models import gpt_loss
from ray_tpu_torch.models.gpt import EXPERTS

from archs.gpt import program as dense
from archs.moonlight.spec import MoonlightSpec


def model(spec: MoonlightSpec, traffic: dict, device):
    return dense.build(dataclasses.replace(
        dense.config(spec, traffic), n_experts=spec.n_experts,
        expert_top_k=spec.top_k, router="sigmoid",
        routed_scale=spec.routed_scale, seq_aux_alpha=spec.aux_alpha,
        bias_update_rate=spec.bias_rate,
        held_experts=(0, spec.held), moe_d_ff=spec.moe_d_ff,
        n_shared_experts=spec.n_shared, first_dense_layers=spec.first_dense,
        kv_lora_rank=spec.kv_lora_rank, qk_nope_head_dim=spec.qk_nope,
        qk_rope_head_dim=spec.qk_rope, v_head_dim=spec.v_head), device)


def loss_fn(spec: MoonlightSpec, traffic: dict):
    return gpt_loss


def launches():
    """``experts.calls``, the expert layer's passes (forward and remat's
    recompute), and ``experts.rows``, the rows they computed on held
    experts."""
    return {"experts.calls": EXPERTS.calls, "experts.rows": EXPERTS.rows}
