"""Parity: the port's ``dp`` train step against ray_tpu.train.train_step's
``dp`` step on the whole batch.

Two gloo ranks on the CPU (tests/torch_dp_worker.py, which imports no JAX)
take three AdamW(3e-4) steps of GPTConfig.tiny() in fp32 with MoE on
(n_experts=4), each given the global batch, as the JAX step is. The ranks
hold unequal masks (targets -1 in rank 1's rows only), so a loss averaged
per rank, or an aux loss computed from per-rank means, would differ from
the whole batch's. JAX runs the same steps on a 2-device CPU mesh. Bounds
are tests/test_torch_train_step.py's: loss 1e-5 and grad norm 1e-4
relative, parameters 1e-5 absolute (1e-4 where a gradient came near 0);
the gradients AdamW was given, 1e-3 of each leaf's largest magnitude
(tests/test_torch_gpt.py). The two ranks' parameters are bit-identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import MeshConfig, build_mesh
from ray_tpu_torch.train import train_step as tts
from test_torch_gpt import GRAD_RTOL
from test_torch_strategies import launch
from test_torch_train_step import (GNORM_RTOL, LOOSE_TOL,
                                         NEAR_ZERO_GRAD, PARAM_TOL)

WORLD = 2
STEPS = 3
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _setup(n_experts, accum):
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig, gpt_init
    jcfg = dataclasses.replace(GPTConfig.tiny(), dtype=jnp.float32,
                               n_experts=n_experts)
    tree = jax.tree_util.tree_map(np.asarray,
                                  gpt_init(jax.random.PRNGKey(0), jcfg))
    rows = 2 * WORLD                       # two rows per rank
    toks = np.random.default_rng(3).integers(
        0, 512, (max(accum, 1), rows, 33)).astype(np.int32)
    toks[:, rows // 2:, 12:] = -1          # rank 1's rows only
    if not accum:
        toks = toks[0]
    return jcfg, tree, toks


def _jax_run(jcfg, tree, toks, accum):
    """Per step (loss, grad_norm, grads), then the final params, of JAX's
    dp step on a 2-device mesh."""
    import jax
    import jax.numpy as jnp
    import optax
    from ray_tpu.models.gpt import gpt_loss
    from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from ray_tpu.parallel.mesh import build_mesh as jbuild_mesh
    from ray_tpu.train.train_step import init_train_state, make_train_step
    mesh = jbuild_mesh(JMeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    opt = optax.adamw(3e-4)
    state = init_train_state(lambda: jax.tree_util.tree_map(jnp.asarray, tree),
                             opt, mesh, "dp")
    loss_fn = lambda p, b: gpt_loss(p, b, jcfg)  # noqa: E731
    step = make_train_step(loss_fn, opt, mesh, "dp", accum_steps=accum,
                           sample_params=state.params, donate=False)
    micro = toks if accum else toks[None]
    grad = jax.jit(lambda p: jax.tree_util.tree_map(
        lambda *g: sum(g) / len(g),
        *[jax.grad(loss_fn)(p, {"tokens": mb}) for mb in micro]))
    steps = []
    for _ in range(STEPS):
        g = convert.flatten(jax.tree_util.tree_map(np.asarray,
                                                   grad(state.params)))
        state, m = step(state, {"tokens": toks})
        steps.append((float(m["loss"]), float(m["grad_norm"]), g))
    final = convert.flatten(jax.tree_util.tree_map(np.asarray, state.params))
    flat = toks.reshape(-1, toks.shape[-1])
    eval_loss = float(gpt_loss(state.params, {"tokens": flat}, jcfg))
    return steps, final, eval_loss


def _run_ranks(tmp_path, tree, toks, n_experts, policy, accum,
               device="cpu", world=WORLD):
    run = dict(tag="", strategy="dp", mesh={"data": world},
               cfg={"n_experts": n_experts, "remat_policy": policy},
               accum_steps=accum, steps=STEPS, tokens="tokens",
               params="param:")
    return launch(tmp_path, [run], {"tokens": toks, **{
        f"param:{k}": v for k, v in convert.flatten(tree).items()}},
        world=world, device=device)


def assert_ranks_match(ranks, j_steps, j_final, j_eval):
    """The ranks' per-step loss, grad norm and AdamW gradients, eval loss
    and final params against a whole-batch run's (module doc's bounds);
    every rank's params bit-identical to rank 0's."""
    r0 = ranks[0]
    names = [k[len("param:"):] for k in r0 if k.startswith("param:")]
    near = {n: np.zeros(r0[f"param:{n}"].shape, bool) for n in names}
    for i, (jl, jn, jg) in enumerate(j_steps):
        for r in ranks:
            assert abs(float(r["loss"][i]) - jl) <= LOSS_RTOL * abs(jl), i
            assert abs(float(r["grad_norm"][i]) - jn) <= GNORM_RTOL * abs(jn)
        for n in names:
            g = r0[f"grad{i}:{n}"]
            assert np.abs(g - jg[n]).max() <= GRAD_RTOL * np.abs(jg[n]).max()
            for x in (g, jg[n]):
                near[n] |= (x != 0) & (np.abs(x) < NEAR_ZERO_GRAD)
    assert r0["loss"][-1] < r0["loss"][0]
    for r in ranks:
        assert abs(float(r["eval_loss"]) - j_eval) <= LOSS_RTOL * abs(j_eval)
    n_loose = n_total = 0
    for n in names:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"param:{n}"], r0[f"param:{n}"])
        err = np.abs(r0[f"param:{n}"] - j_final[n])
        assert err[~near[n]].max(initial=0.0) <= PARAM_TOL, n
        assert err[near[n]].max(initial=0.0) <= LOOSE_TOL, n
        n_loose += int(near[n].sum())
        n_total += near[n].size
    assert n_loose <= 1e-3 * n_total, (n_loose, n_total)


@pytest.mark.timeout(420)
@pytest.mark.parametrize("policy,accum", [("full", 0), ("dots", 2)])
def test_two_rank_dp_matches_jax_whole_batch(jx, tmp_path, policy, accum):
    jcfg, tree, toks = _setup(4, accum)
    ranks = _run_ranks(tmp_path, tree, toks, 4, policy, accum)
    assert_ranks_match(ranks, *_jax_run(jcfg, tree, toks, accum))


def test_dp_on_a_mesh_of_one_is_the_single_device_step():
    """build_mesh(MeshConfig(data=1)) with "dp" runs no collective and
    gives the mesh=None step's numbers bit for bit, MoE and accum on."""
    cfg = dataclasses.replace(tgpt.GPTConfig.tiny(), dtype=torch.float32,
                              n_experts=4)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 2, 33))).long()
    runs = []
    for mesh in (None, build_mesh(MeshConfig(data=1), devices=["cpu"])):
        opt = tts.adamw(3e-4)
        state = tts.init_train_state(
            lambda: tgpt.gpt_init(cfg, device="cpu"), opt, mesh, "dp")
        step = tts.make_train_step(tgpt.gpt_loss, opt, mesh, "dp",
                                   accum_steps=2)
        for _ in range(2):
            state, m = step(state, {"tokens": toks})
        runs.append((float(m["loss"]), float(m["grad_norm"]),
                     [p.detach().clone() for p in state.params.parameters()]))
    (l0, n0, p0), (l1, n1, p1) = runs
    assert (l0, n0) == (l1, n1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_dp_rows_split_the_global_batch():
    """Each rank of the data axis takes its contiguous rows (dim 0, dim 1
    under accum_steps), as P("data") shards the JAX batch; rows that do
    not divide raise."""
    mesh = build_mesh(MeshConfig(data=1), devices=["cpu"])
    dp = tts._DataParallel(mesh, "dp")
    dp.size, dp.index = 4, 2
    batch = {"tokens": torch.arange(2 * 8 * 3).reshape(2, 8, 3)}
    assert torch.equal(dp.rows(batch, 1)["tokens"],
                       batch["tokens"][:, 4:6])
    assert torch.equal(dp.rows({"t": batch["tokens"][0]}, 0)["t"],
                       batch["tokens"][0, 4:6])
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        dp.rows({"t": torch.zeros(6, 3)}, 0)
