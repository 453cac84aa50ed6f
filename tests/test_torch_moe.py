"""Parity: the port's MoE layers (ray_tpu_torch.models.gpt._moe_block and
the Switch aux loss) against ray_tpu.models.gpt.

GPTConfig.tiny() with n_experts=4 (the expert count of
tests/test_parallel.py::TestTrainStep::test_moe_expert_parallel) in fp32,
JAX weights moved in through params_from_jax, tokens from a numpy seed.
JAX's flash attention runs its Pallas kernels in interpret mode on the
CPU; the port's runs the kernels' plain versions. Bounds are
tests/test_torch_gpt.py's: logits 1e-4 absolute; loss and aux 1e-5
relative; each grad leaf 1e-3 of that leaf's largest magnitude. Routing
is compared for equality: with random fp32 inputs no two router
probabilities of a token tie, so top-k picks the same experts in the same
order in both frameworks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from test_torch_gpt import (GRAD_RTOL, LOGITS_TOL, LOSS_RTOL, _cfgs,
                                  _jax_params, _tokens, _torch_model)

N_EXPERTS = 4


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


@pytest.fixture(scope="module")
def moe(jx):
    jcfg, tcfg = _cfgs(n_experts=N_EXPERTS)
    return jcfg, tcfg, _jax_params(jcfg)


def test_moe_state_dict_matches_jax(moe):
    """layers.<i>.moe.{router,w_gate,w_up,w_down} under the JAX names and
    shapes, no mlp, and the conversion both ways is exact."""
    jcfg, tcfg, tree = moe
    flat = convert.flatten(tree)
    assert "layers.0.moe.w_gate" in flat and "layers.0.mlp.w_gate" not in flat
    model = tgpt.gpt_init(tcfg, device="cpu")
    sd = model.state_dict()
    assert sorted(sd) == sorted(flat)
    for name, leaf in flat.items():
        assert tuple(sd[name].shape) == leaf.shape, name
    back = convert.params_to_numpy(_torch_model(tcfg, tree))
    for name, leaf in convert.flatten(back).items():
        np.testing.assert_array_equal(leaf, flat[name])


def test_moe_init_scales_match_jax(moe):
    """The port's init draws other numbers but at the JAX init's scales:
    router 0.02, w_gate/w_up 1/sqrt(e) (the JAX init scales by the first
    dim), w_down 1/sqrt(2 L ff); std within 5%."""
    jcfg, tcfg, tree = moe
    gen = torch.Generator().manual_seed(1)
    model = tgpt.gpt_init(tcfg, device="cpu", generator=gen)
    flat = convert.flatten(tree)
    for name, p in model.named_parameters():
        if ".moe." in name:
            ref = float(np.std(flat[name]))
            assert abs(float(p.detach().std()) - ref) <= 0.05 * ref, name


@pytest.mark.parametrize("attention", ["flash", "reference"])
def test_moe_logits_and_aux_match_jax(jx, attention):
    from ray_tpu.models.gpt import gpt_forward
    jcfg, tcfg = _cfgs(n_experts=N_EXPERTS, attention=attention)
    tree = _jax_params(jcfg)
    toks = _tokens()[:, :64]
    j_logits, j_aux = gpt_forward(tree, toks, jcfg)
    t_logits, t_aux = tgpt.gpt_forward(_torch_model(tcfg, tree),
                                       torch.from_numpy(toks).long())
    assert np.abs(t_logits.detach().numpy() - np.asarray(j_logits)).max() \
        < LOGITS_TOL
    assert t_aux.shape == ()
    t_aux = float(t_aux.detach())
    assert abs(t_aux - float(j_aux)) <= LOSS_RTOL * abs(float(j_aux))


def _jax_routing(monkeypatch, jcfg, tree, toks):
    """Each layer's top-k expert indices in the JAX model, recorded from
    jax.lax.top_k in an eager forward (remat none: nothing is traced)."""
    import jax
    from ray_tpu.models.gpt import gpt_forward
    seen = []
    top_k = jax.lax.top_k

    def record(x, k):
        out = top_k(x, k)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", record)
    gpt_forward(tree, toks, dataclasses.replace(jcfg, remat_policy="none"))
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return seen


def _torch_routing(monkeypatch, tcfg, tree, toks):
    seen = []
    route = tgpt._route

    def record(moe, x, cfg):
        out = route(moe, x, cfg)
        seen.append(out[2].numpy().copy())
        return out

    monkeypatch.setattr(tgpt, "_route", record)
    with torch.no_grad():
        tgpt.gpt_forward(_torch_model(tcfg, tree),
                         torch.from_numpy(toks).long())
    return seen


def test_moe_routing_indices_equal_jax(moe, monkeypatch):
    jcfg, tcfg, tree = moe
    toks = _tokens(b=4, s=64, seed=5)
    j_idx = _jax_routing(monkeypatch, jcfg, tree, toks)
    t_idx = _torch_routing(monkeypatch, tcfg, tree, toks)
    assert len(j_idx) == len(t_idx) == jcfg.n_layers
    for layer, (a, b) in enumerate(zip(t_idx, j_idx)):
        assert a.shape == (4, 64, jcfg.expert_top_k)
        np.testing.assert_array_equal(a, b, err_msg=f"layer {layer}")
    # Every expert is someone's top-1 somewhere: the check sees routing,
    # not one expert chosen everywhere.
    assert all(len(np.unique(a[..., 0])) == N_EXPERTS for a in t_idx)


@pytest.mark.parametrize("attention", ["flash", "reference"])
def test_moe_loss_and_grads_match_jax(jx, attention):
    """gpt_loss = mean cross-entropy + 0.01 aux / n_layers, and its grads,
    router included (through the top-k weights and the aux loss)."""
    import jax
    from ray_tpu.models.gpt import gpt_loss
    jcfg, tcfg = _cfgs(n_experts=N_EXPERTS, attention=attention)
    tree = _jax_params(jcfg)
    toks = _tokens()
    toks[1, 40:] = -1                      # masked targets
    j_loss, j_grads = jax.value_and_grad(
        lambda p: gpt_loss(p, {"tokens": toks}, jcfg))(tree)
    model = _torch_model(tcfg, tree)
    t_loss = tgpt.gpt_loss(model, {"tokens": torch.from_numpy(toks).long()})
    t_loss.backward()
    t_val, j_val = float(t_loss.detach()), float(j_loss)
    assert abs(t_val - j_val) <= LOSS_RTOL * abs(j_val)
    j_flat = convert.flatten(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in model.named_parameters():
        ref = j_flat[name]
        assert np.abs(ref).max() > 0, name
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= GRAD_RTOL * np.abs(ref).max(), name


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_moe_block_matches_jax(moe, top_k):
    """One MoE block on random hidden states, each top-k: output and the
    layer's aux loss (JAX's _moe_block returns it; the port's stats give it
    through _switch_aux)."""
    from ray_tpu.models.gpt import _moe_block
    jcfg, tcfg, tree = moe
    jcfg = dataclasses.replace(jcfg, expert_top_k=top_k)
    tcfg = dataclasses.replace(tcfg, expert_top_k=top_k)
    x = np.random.default_rng(7).standard_normal((2, 48, jcfg.d_model)
                                                 ).astype(np.float32)
    j_y, j_aux = _moe_block(tree["layers"][1], x, jcfg)
    model = _torch_model(tcfg, tree)
    with torch.no_grad():
        t_y, stats = tgpt._moe_block(model.layers[1], torch.from_numpy(x),
                                     tcfg)
        t_aux = tgpt._switch_aux(stats[None], 2 * 48, N_EXPERTS)
    assert np.abs(t_y.numpy() - np.asarray(j_y)).max() <= 1e-5 * max(
        1.0, float(np.abs(np.asarray(j_y)).max()))
    assert abs(float(t_aux) - float(j_aux)) <= LOSS_RTOL * abs(float(j_aux))
