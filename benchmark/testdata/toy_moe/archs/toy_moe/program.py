"""The routed-expert GPT in the port: the dense family's ``GPTConfig`` with
``n_experts`` and ``expert_top_k``, and the same loss (``gpt_loss`` adds
the Switch loss)."""

from __future__ import annotations

import dataclasses

from archs.gpt import program as dense


def model(spec, traffic: dict, device):
    return dense.build(dataclasses.replace(
        dense.config(spec, traffic), n_experts=spec.n_experts,
        expert_top_k=spec.top_k), device)


loss_fn = dense.loss_fn
