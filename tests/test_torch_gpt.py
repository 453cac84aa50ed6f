"""Parity: ray_tpu_torch.models.gpt against ray_tpu.models.gpt.

GPTConfig.tiny() in fp32, JAX weights moved in through params_from_jax,
tokens from a numpy seed. JAX's flash attention runs its Pallas kernels
in interpret mode on the CPU; the port's runs the kernels' plain versions.

Tolerances (fp32, two frameworks summing in different orders): logits
1e-4 absolute; loss 1e-5 relative; each grad leaf 1e-3 of that leaf's
largest magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt

LOGITS_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _cfgs(**kw):
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig
    jcfg = dataclasses.replace(GPTConfig.tiny(), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tgpt.GPTConfig.tiny(), dtype=torch.float32,
                               **kw)
    return jcfg, tcfg


def _jax_params(jcfg):
    import jax
    from ray_tpu.models.gpt import gpt_init
    return jax.tree_util.tree_map(np.asarray,
                                  gpt_init(jax.random.PRNGKey(0), jcfg))


def _torch_model(tcfg, tree):
    model = tgpt.gpt_init(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(tree))
    return model


def _tokens(b=2, s=65, vocab=512, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module")
def tiny(jx):
    jcfg, tcfg = _cfgs()
    tree = _jax_params(jcfg)
    return jcfg, tcfg, tree


def test_state_dict_names_and_shapes_match_jax(tiny):
    jcfg, tcfg, tree = tiny
    model = tgpt.gpt_init(tcfg, device="cpu")
    flat = convert.flatten(tree)
    sd = model.state_dict()
    assert sorted(sd) == sorted(flat)
    for name, leaf in flat.items():
        assert tuple(sd[name].shape) == leaf.shape, name
    assert tgpt.count_params(model) == sum(x.size for x in flat.values())
    back = convert.params_to_numpy(_torch_model(tcfg, tree))
    for name, leaf in convert.flatten(back).items():
        np.testing.assert_array_equal(leaf, flat[name])


def test_logits_match_jax(tiny):
    from ray_tpu.models.gpt import gpt_forward
    jcfg, tcfg, tree = tiny
    toks = _tokens()[:, :64]
    j_logits, _ = gpt_forward(tree, toks, jcfg)
    t_logits, aux = tgpt.gpt_forward(_torch_model(tcfg, tree),
                                     torch.from_numpy(toks).long())
    assert aux == 0.0
    assert np.abs(t_logits.detach().numpy() - np.asarray(j_logits)).max() \
        < LOGITS_TOL


# The tiny config (head dim 32) with each attention, and flash at head dim
# 48 (d_model 96 over 2 heads), a width the card's kernels pad to 64.
@pytest.mark.parametrize("attention,widths", [
    ("flash", {}), ("reference", {}),
    ("flash", {"d_model": 96, "n_heads": 2})],
    ids=["flash", "reference", "flash-head_dim48"])
def test_loss_and_grads_match_jax(jx, attention, widths):
    import jax
    from ray_tpu.models.gpt import gpt_loss
    jcfg, tcfg = _cfgs(attention=attention, **widths)
    tree = _jax_params(jcfg)
    toks = _tokens()
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
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= GRAD_RTOL * np.abs(ref).max(), name


def _xent_inputs(n=200, d=16, vocab=64, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((d, vocab)).astype(np.float32)
    t = rng.integers(0, vocab, (n,))
    mask = (rng.random(n) > 0.2).astype(np.float32)
    return x, w, t, mask


@pytest.mark.parametrize("chunk_rows", [48, 64, 199])
def test_chunked_xent_padding_matches_one_chunk(chunk_rows):
    """200 rows in chunks of 48/64/199 (padded) against one 16384-row call,
    values and grads (fp32, 1e-5 of the largest magnitude: the weight grad
    sums 200 rows in another order when chunked)."""
    x, w, t, mask = _xent_inputs()

    def run(rows):
        tx = torch.tensor(x, requires_grad=True)
        tw = torch.tensor(w, requires_grad=True)
        total, denom = tgpt.chunked_xent(tx, tw, torch.from_numpy(t),
                                         torch.from_numpy(mask), rows)
        total.backward()
        return float(total.detach()), float(denom), tx.grad.numpy(), tw.grad.numpy()

    total, denom, gx, gw = run(chunk_rows)
    total1, denom1, gx1, gw1 = run(16384)
    assert denom == denom1 == float(mask.sum())
    assert abs(total - total1) <= 1e-5 * abs(total1)
    for a, b in ((gx, gx1), (gw, gw1)):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_chunked_xent_matches_jax(jx):
    from ray_tpu.models.gpt import chunked_xent
    x, w, t, mask = _xent_inputs()
    j_total, j_denom = chunked_xent(x, w, t.astype(np.int32), mask, 48)
    t_total, t_denom = tgpt.chunked_xent(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t),
        torch.from_numpy(mask), 48)
    assert float(t_denom) == float(j_denom)
    assert abs(float(t_total) - float(j_total)) <= LOSS_RTOL * abs(
        float(j_total))


def test_remat_full_matches_none(tiny):
    """Per-layer checkpointing recomputes the same values: loss and grads
    agree with no remat to fp32 rounding (1e-6)."""
    _, tcfg, tree = tiny
    toks = torch.from_numpy(_tokens()).long()
    results = []
    for policy in ("full", "none"):
        model = _torch_model(dataclasses.replace(tcfg, remat_policy=policy),
                             tree)
        loss = tgpt.gpt_loss(model, {"tokens": toks})
        loss.backward()
        results.append((float(loss.detach()),
                        [p.grad.clone() for p in model.parameters()]))
    (l_full, g_full), (l_none, g_none) = results
    assert abs(l_full - l_none) <= 1e-6 * abs(l_none)
    for a, b in zip(g_full, g_none):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            1.0, float(b.abs().max()))


def test_masked_targets_are_ignored(tiny):
    """Targets below 0 drop out of both sum and count."""
    _, tcfg, tree = tiny
    model = _torch_model(tcfg, tree)
    toks = torch.from_numpy(_tokens()).long()
    masked = toks.clone()
    masked[:, 33:] = -1
    full = tgpt.gpt_loss(model, {"tokens": toks[:, :33]})
    part = tgpt.gpt_loss(model, {"tokens": masked})
    assert abs(float(full.detach()) - float(part.detach())) <= 1e-5 * abs(
        float(full.detach()))
