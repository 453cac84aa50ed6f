"""Parity at a wide head: the port's GPT with head dim 256 and tied
embeddings against ray_tpu.models.gpt.

Two layers, d_model 512 over 2 heads (head dim 256, the width of Gemma's
heads and of chip_smoke.py's phase (t)), d_ff 1024, vocab 512, seq 64,
``tie_embeddings=True`` (the LM head is the embedding table, transposed)
and RMSNorm eps 1e-6, in fp32. JAX's weights move in through
``params_from_jax``; tokens come from a numpy seed. JAX's flash attention
runs its Pallas kernels in interpret mode on the CPU; the port's runs the
kernels' plain versions.

Tolerances (fp32, two frameworks summing in different orders): logits and
the loss within 2e-5 of their largest magnitude, each gradient leaf within
2e-4 of its largest magnitude, the bounds
tests/test_parallel.py::TestAttention holds the Pallas kernels to. After
one AdamW(3e-4) step, each parameter within 1e-5 (test_torch_train_step's
bound after three steps), except where a gradient is rounding noise (0 <
|g| < 1e-7 in either package): Adam's first update g / (|g| + eps) then
turns on that noise and may differ by up to 2 lr between the packages.
Those elements are held to 2 lr and must be under 0.1% of the elements.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_train_step as ts
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.train import train_step as tts

VALUE_RTOL = 2e-5
GRAD_RTOL = 2e-4
LR = 3e-4
WIDE = dict(vocab_size=512, d_model=512, n_layers=2, n_heads=2, d_ff=1024,
            max_seq=64, tie_embeddings=True, rmsnorm_eps=1e-6)


@pytest.fixture(scope="module")
def wide(jax_cpu):
    """(JAX config, port config, JAX's weights as numpy, tokens [2, 65])."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig, gpt_init
    jcfg = GPTConfig(dtype=jnp.float32, **WIDE)
    tcfg = tgpt.GPTConfig(dtype=torch.float32, **WIDE)
    assert tcfg.head_dim == 256
    tree = jax.tree_util.tree_map(np.asarray,
                                  gpt_init(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(0).integers(0, 512, (2, 65)).astype(
        np.int32)
    return jcfg, tcfg, tree, toks


def _model(tcfg, tree):
    model = tgpt.gpt_init(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(tree))
    return model


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-30)


def test_tied_head_has_no_weight_of_its_own(wide):
    """Tied, neither package has an lm_head: the names and shapes equal
    JAX's tree, and the head reads the embedding table."""
    _, tcfg, tree, _ = wide
    assert "lm_head" not in tree
    model = _model(tcfg, tree)
    flat = convert.flatten(tree)
    sd = model.state_dict()
    assert sorted(sd) == sorted(flat)
    for name, leaf in flat.items():
        assert tuple(sd[name].shape) == leaf.shape, name
    head, _ = tgpt._head(model)
    assert torch.equal(head, model.embed.table.t())


def test_logits_match_jax(wide):
    from ray_tpu.models.gpt import gpt_forward
    jcfg, tcfg, tree, toks = wide
    j_logits, _ = gpt_forward(tree, toks[:, :64], jcfg)
    t_logits, _ = tgpt.gpt_forward(_model(tcfg, tree),
                                   torch.from_numpy(toks[:, :64]).long())
    assert _close(t_logits.detach().numpy(), j_logits, VALUE_RTOL)


@pytest.mark.parametrize("attention", ["flash", "reference"])
def test_loss_and_grads_match_jax(wide, attention):
    """The tied table's gradient sums the embedding lookup's and the
    head's parts in both packages."""
    import jax
    from ray_tpu.models.gpt import gpt_loss
    jcfg, tcfg, tree, toks = wide
    jcfg = dataclasses.replace(jcfg, attention=attention)
    tcfg = dataclasses.replace(tcfg, attention=attention)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: gpt_loss(p, {"tokens": toks}, jcfg))(tree)
    model = _model(tcfg, tree)
    t_loss = tgpt.gpt_loss(model, {"tokens": torch.from_numpy(toks).long()})
    t_loss.backward()
    assert _close(float(t_loss.detach()), float(j_loss), VALUE_RTOL)
    j_flat = convert.flatten(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in model.named_parameters():
        assert _close(p.grad.numpy(), j_flat[name], GRAD_RTOL), name


def test_adamw_step_matches_jax(wide):
    """One AdamW(3e-4) step through each package's make_train_step ("dp"
    on a one-device mesh in JAX): loss, grad norm and the parameters."""
    import jax
    import optax
    from ray_tpu.models.gpt import gpt_loss
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.train.train_step import init_train_state, make_train_step
    jcfg, tcfg, tree, toks = wide
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    opt = optax.adamw(LR)
    jstate = init_train_state(lambda: jax.tree_util.tree_map(
        jax.numpy.asarray, tree), opt, mesh, "dp")
    jstep = make_train_step(lambda p, b: gpt_loss(p, b, jcfg), opt, mesh,
                            "dp", sample_params=jstate.params, donate=False)
    topt = tts.adamw(LR)
    tstate = tts.init_train_state(lambda: _model(tcfg, tree), topt)
    tstep = tts.make_train_step(tgpt.gpt_loss, topt)
    ttoks = torch.from_numpy(toks).long()

    names = [n for n, _ in tstate.params.named_parameters()]
    jg = convert.flatten(jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: gpt_loss(p, {"tokens": toks}, jcfg))(jstate.params)))
    near_zero = ts._near_zero(ts._torch_grads(tstate.params, ttoks))
    near_zero = ts._near_zero([jg[n] for n in names], near_zero)
    jstate, jm = jstep(jstate, {"tokens": toks})
    tstate, tm = tstep(tstate, {"tokens": ttoks})
    assert tm["step"] == int(jm["step"]) == 1
    assert _close(float(tm["loss"]), float(jm["loss"]), VALUE_RTOL)
    assert _close(float(tm["grad_norm"]), float(jm["grad_norm"]), GRAD_RTOL)
    j_params = convert.flatten(jax.tree_util.tree_map(np.asarray,
                                                      jstate.params))
    n_noise = n_total = 0
    for (name, p), noise in zip(tstate.params.named_parameters(), near_zero):
        err = np.abs(p.detach().numpy() - j_params[name])
        assert err[~noise].max(initial=0.0) <= ts.PARAM_TOL, name
        assert err[noise].max(initial=0.0) <= 2 * LR, name
        n_noise += int(noise.sum())
        n_total += noise.size
    assert n_noise <= 1e-3 * n_total, (n_noise, n_total)
