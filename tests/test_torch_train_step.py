"""Parity: ray_tpu_torch.train.train_step against ray_tpu.train.train_step.

Three AdamW(3e-4) steps on GPTConfig.tiny() in fp32 from the same JAX
weights and tokens; JAX runs make_train_step on a one-device CPU mesh.

Tolerances (fp32): parameters 1e-5 absolute after three steps (AdamW moves
each weight by about lr = 3e-4 a step, so this is a few percent of one
update); loss 1e-5 and grad_norm 1e-4 relative.

One exception, from Adam itself: where a gradient is near 0 but not 0
(0 < |g| < 10 * eps = 1e-7 at some step, in either framework), the update
g / (|g| + eps) turns on rounding noise in g (two frameworks summing in
different orders disagree by ~1e-9 of the largest gradient). Such elements
are held to LOOSE_TOL, about three times the largest error measured among
them (3.7e-5 after three steps, the same on 1, 3 and 8 CPU threads), and
must stay under 0.1% of the elements.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.train import train_step as tts

PARAM_TOL = 1e-5
LOOSE_TOL = 1e-4
NEAR_ZERO_GRAD = 1e-7
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _setup():
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig, gpt_init
    jcfg = dataclasses.replace(GPTConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tgpt.GPTConfig.tiny(), dtype=torch.float32)
    tree = jax.tree_util.tree_map(np.asarray,
                                  gpt_init(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(3).integers(0, 512, (4, 33)).astype(np.int32)
    return jcfg, tcfg, tree, toks


def _torch_model(tcfg, tree):
    model = tgpt.gpt_init(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(tree))
    return model


def _near_zero(grads, flags=None):
    """Per leaf, where 0 < |grad| < NEAR_ZERO_GRAD, or-ed into flags."""
    near = [(g != 0) & (np.abs(g) < NEAR_ZERO_GRAD) for g in grads]
    return near if flags is None else [a | b for a, b in zip(flags, near)]


def _torch_grads(model, toks):
    loss = tgpt.gpt_loss(model, {"tokens": toks})
    return [g.numpy() for g in
            torch.autograd.grad(loss, list(model.parameters()))]


def _assert_params_close(model, ref, near_zero):
    """ref: {name: array}. Elements whose gradient came near 0 at some step
    are held to LOOSE_TOL instead of PARAM_TOL (module doc)."""
    n_loose = n_total = 0
    for (name, p), loose in zip(model.named_parameters(), near_zero):
        err = np.abs(p.detach().numpy() - ref[name])
        assert err[~loose].max(initial=0.0) <= PARAM_TOL, name
        assert err[loose].max(initial=0.0) <= LOOSE_TOL, name
        n_loose += int(loose.sum())
        n_total += loose.size
    assert n_loose <= 1e-3 * n_total, (n_loose, n_total)


def test_three_adamw_steps_match_jax(jx):
    import jax
    import optax
    from ray_tpu.models.gpt import gpt_loss
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.train.train_step import init_train_state, make_train_step
    jcfg, tcfg, tree, toks = _setup()

    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    opt = optax.adamw(3e-4)
    jstate = init_train_state(lambda: jax.tree_util.tree_map(
        jax.numpy.asarray, tree), opt, mesh, "dp")
    jstep = make_train_step(lambda p, b: gpt_loss(p, b, jcfg), opt, mesh,
                            "dp", sample_params=jstate.params, donate=False)

    topt = tts.adamw(3e-4)
    tstate = tts.init_train_state(lambda: _torch_model(tcfg, tree), topt)
    tstep = tts.make_train_step(tgpt.gpt_loss, topt)

    jgrad = jax.jit(jax.grad(lambda p: gpt_loss(p, {"tokens": toks}, jcfg)))
    names = [n for n, _ in tstate.params.named_parameters()]

    losses, near_zero = [], None
    ttoks = torch.from_numpy(toks).long()
    for i in range(3):
        jg = convert.flatten(jax.tree_util.tree_map(
            np.asarray, jgrad(jstate.params)))
        near_zero = _near_zero(_torch_grads(tstate.params, ttoks), near_zero)
        near_zero = _near_zero([jg[n] for n in names], near_zero)
        jstate, jm = jstep(jstate, {"tokens": toks})
        tstate, tm = tstep(tstate, {"tokens": ttoks})
        assert tm["step"] == int(jm["step"]) == i + 1
        jl, tl = float(jm["loss"]), float(tm["loss"])
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
        jn, tn = float(jm["grad_norm"]), float(tm["grad_norm"])
        assert abs(tn - jn) <= GNORM_RTOL * abs(jn)
        losses.append(tl)
    assert losses[-1] < losses[0]
    j_flat = convert.flatten(jax.tree_util.tree_map(np.asarray,
                                                    jstate.params))
    _assert_params_close(tstate.params, j_flat, near_zero)


def test_adamw_defaults_are_optax(jx):
    """One update on a lone tensor, optax against the port (fp32, 1e-7):
    weight_decay defaults to optax's 1e-4, not torch.optim.AdamW's 1e-2."""
    import optax
    rng = np.random.default_rng(0)
    p = rng.standard_normal(64).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    opt = optax.adamw(3e-4)
    state = opt.init(p)
    ref = p
    for _ in range(2):
        upd, state = opt.update(g, state, ref)
        ref = np.asarray(optax.apply_updates(ref, upd))
    topt = tts.adamw(3e-4)
    assert topt.weight_decay == 1e-4
    tp = torch.from_numpy(p.copy())
    tstate = topt.init([tp])
    for _ in range(2):
        tstate = topt.update([torch.from_numpy(g)], tstate, [tp])
    assert tstate.count == 2
    assert np.abs(tp.numpy() - ref).max() <= 1e-7


def test_accum_steps_matches_flat_batch():
    """accum_steps=2 over two halves of the batch equals one step on the
    whole batch: same loss and grad norm (fp32 sums in another order: 1e-6
    relative) and parameters (as against JAX, module doc)."""
    _, tcfg, tree, toks = _setup()
    batch = torch.from_numpy(toks).long()
    results = []
    near_zero = _near_zero(_torch_grads(_torch_model(tcfg, tree), batch))
    for accum, b in ((0, batch), (2, batch.reshape(2, 2, -1))):
        opt = tts.adamw(3e-4)
        state = tts.init_train_state(lambda: _torch_model(tcfg, tree), opt)
        step = tts.make_train_step(tgpt.gpt_loss, opt, accum_steps=accum)
        state, m = step(state, {"tokens": b})
        results.append((float(m["loss"]), float(m["grad_norm"]),
                        state.params))
    (l0, n0, flat), (l1, n1, accum) = results
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    assert abs(n1 - n0) <= 1e-6 * abs(n0)
    ref = {n: p.detach().numpy() for n, p in flat.named_parameters()}
    _assert_params_close(accum, ref, near_zero)


def test_eval_step_matches_loss():
    _, tcfg, tree, toks = _setup()
    model = _torch_model(tcfg, tree)
    batch = {"tokens": torch.from_numpy(toks).long()}
    ev = tts.make_eval_step(tgpt.gpt_loss)(model, batch)
    assert not ev.requires_grad
    assert float(ev) == float(tgpt.gpt_loss(model, batch).detach())


@pytest.mark.parametrize("kw,error,match", [
    (dict(mesh=object()), TypeError, "parallel.mesh.Mesh"),
    (dict(mesh=object(), strategy="dp"), TypeError, "parallel.mesh.Mesh"),
])
def test_sharding_is_not_ported(kw, error, match):
    """A mesh that is not the port's raises TypeError in every entry point.
    (Every preset is executed: pp and pp_tp in tests/test_torch_pipeline.py.)"""
    opt = tts.adamw(3e-4)
    for build in (lambda: tts.make_train_step(tgpt.gpt_loss, opt, **kw),
                  lambda: tts.make_eval_step(tgpt.gpt_loss, **kw),
                  lambda: tts.init_train_state(
                      lambda: pytest.fail("init_fn ran"), opt, **kw)):
        with pytest.raises(error, match=match):
            build()
