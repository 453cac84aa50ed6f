"""Remat policies of the port's GPT (``remat_policy`` "full" | "dots" |
"none") against each other and against ray_tpu.models.gpt's "dots"
(jax.checkpoint_policies.dots_with_no_batch_dims_saveable).

GPTConfig.tiny() in fp32, dense and with n_experts=4, JAX weights moved in
through params_from_jax, tokens from a numpy seed. The three policies
compute the same values, so the port's loss and grads agree among them to
fp32 rounding (1e-6, as tests/test_torch_gpt.py::test_remat_full_matches_none)
and with JAX's "dots" to tests/test_torch_gpt.py's bounds.

Equal values would also come from a "dots" that silently recomputes
everything, so two tests look at what runs in backward: no weight product
(aten.mm of the forward) runs again under "dots", and the flash-attention
forward does (its kernel output is no product; JAX recomputes its
pallas_call too).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import attention as tat
from test_torch_gpt import (GRAD_RTOL, LOSS_RTOL, _cfgs, _jax_params,
                                  _tokens, _torch_model)

POLICIES = ("full", "dots", "none")


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


@pytest.fixture(scope="module", params=[0, 4], ids=["dense", "moe"])
def setup(request, jx):
    jcfg, tcfg = _cfgs(n_experts=request.param)
    return jcfg, tcfg, _jax_params(jcfg)


def _loss_and_grads(tcfg, tree, policy, toks):
    model = _torch_model(dataclasses.replace(tcfg, remat_policy=policy), tree)
    loss = tgpt.gpt_loss(model, {"tokens": torch.from_numpy(toks).long()})
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy().copy()
                                  for n, p in model.named_parameters()}


def test_dots_matches_full_and_none(setup):
    _, tcfg, tree = setup
    toks = _tokens()
    res = {p: _loss_and_grads(tcfg, tree, p, toks) for p in POLICIES}
    l_dots, g_dots = res["dots"]
    for other in ("full", "none"):
        l_o, g_o = res[other]
        assert abs(l_dots - l_o) <= 1e-6 * abs(l_o), other
        for name, ref in g_o.items():
            err = np.abs(g_dots[name] - ref).max()
            assert err <= 1e-6 * max(1.0, np.abs(ref).max()), (other, name)


def test_dots_matches_jax_dots(setup):
    import jax
    from ray_tpu.models.gpt import gpt_loss
    jcfg, tcfg, tree = setup
    jcfg = dataclasses.replace(jcfg, remat_policy="dots")
    toks = _tokens()
    j_loss, j_grads = jax.value_and_grad(
        lambda p: gpt_loss(p, {"tokens": toks}, jcfg))(tree)
    t_loss, t_grads = _loss_and_grads(tcfg, tree, "dots", toks)
    assert abs(t_loss - float(j_loss)) <= LOSS_RTOL * abs(float(j_loss))
    j_flat = convert.flatten(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, grad in t_grads.items():
        ref = j_flat[name]
        assert np.abs(grad - ref).max() <= GRAD_RTOL * np.abs(ref).max(), name


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(tcfg, tree, policy, toks):
    """{aten op: calls} during the backward of the layers alone (the loss
    is the sum of the backbone's output, so no chunked_xent runs)."""
    model = _torch_model(dataclasses.replace(tcfg, remat_policy=policy), tree)
    x, aux = tgpt.gpt_backbone(model, torch.from_numpy(toks).long())
    loss = x.sum() + aux
    with _CountOps() as mode:
        loss.backward()
    return mode.counts


def test_dots_recomputes_no_weight_product(setup):
    """Backward runs the same aten.mm calls under "dots" as under "none"
    (the gradients' products only), while "full" adds the forward's weight
    products of every layer that backward reads: dense q, k, v, o, gate
    and up (the recompute stops before w_down's, whose output no gradient
    needs); MoE q, k, v, o, router, gate and up (the expert
    down-projection is a batched product). "dots" recomputes the batched
    products (aten.bmm) as "full" does."""
    _, tcfg, tree = setup
    toks = _tokens()[:, :64]
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    ops = {p: _backward_ops(tcfg, tree, p, toks) for p in POLICIES}
    assert ops["dots"][mm] == ops["none"][mm]
    per_layer = 7 if tcfg.n_experts else 6
    assert ops["full"][mm] - ops["none"][mm] == per_layer * tcfg.n_layers
    assert ops["dots"][bmm] == ops["full"][bmm] > ops["none"][bmm]


def test_dots_recomputes_flash_forward(setup, monkeypatch):
    """The flash forward (K1 on the card) runs 2 L times per step under
    "full" and "dots", L under "none"; its backward (K2, K3) L times."""
    _, tcfg, tree = setup
    toks = _tokens()
    calls = {}

    def counted(name):
        fn = getattr(tat, name)

        def run(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(tat, name, run)

    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        counted(name)
    n = tcfg.n_layers
    for policy, fwd in (("full", 2 * n), ("dots", 2 * n), ("none", n)):
        calls.clear()
        _loss_and_grads(tcfg, tree, policy, toks)
        assert calls == {"flash_fwd": fwd, "flash_bwd_dq": n,
                         "flash_bwd_dkv": n}, policy
