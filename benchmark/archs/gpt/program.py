"""The dense GPT family in the port: ``ray_tpu_torch.models``'s GPT at the
spec's widths and the traffic's sequence, type and remat policy, on the
flash attention kernels, and its loss (``harness/program.py`` calls
``model`` and ``loss_fn``)."""

from __future__ import annotations

import torch
from ray_tpu_torch.models import GPTConfig, gpt_init, gpt_loss

from archs.gpt.spec import ModelSpec


def config(spec: ModelSpec, traffic: dict) -> GPTConfig:
    return GPTConfig(
        vocab_size=spec.vocab, d_model=spec.d_model,
        n_layers=spec.n_layers, n_heads=spec.n_heads, d_ff=spec.d_ff,
        max_seq=traffic["seq"], dtype=getattr(torch, traffic["dtype"]),
        rope_theta=spec.rope_theta, rmsnorm_eps=spec.norm_eps,
        remat=True, remat_policy=traffic["remat"], attention="flash",
        tie_embeddings=spec.tied)


def build(cfg: GPTConfig, device) -> torch.nn.Module:
    """The port's GPT of ``cfg`` on ``device``, its own draw from seed 0
    (the benchmark's weights are copied over it)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return gpt_init(cfg, device=device, generator=gen)


def model(spec: ModelSpec, traffic: dict, device) -> torch.nn.Module:
    return build(config(spec, traffic), device)


def loss_fn(spec: ModelSpec, traffic: dict):
    return gpt_loss
