"""Parity: the port's sharded train step against ray_tpu.train.train_step's
on the same mesh, for tests/test_parallel.py::TestTrainStep's matrix.

Eight gloo ranks on the CPU (tests/torch_dp_worker.py, which imports no
JAX), one launch per mesh layout, take three AdamW(3e-4) steps of
GPTConfig.tiny() in fp32 through build_mesh -> init_train_state ->
make_train_step with the strategy, each rank given the global batch, as
the JAX step is; JAX runs the same strategy on the conftest's 8-device CPU
mesh. Targets are -1 from position 12 in the rows of one coordinate of the
batch axes only, so that a loss or a count averaged per rank would differ
from the whole batch's.

Held: each step's loss (1e-5) and grad norm (1e-4, relative) on every rank;
the eval loss; the final parameters gathered whole (1e-5 absolute, with
tests/test_torch_train_step.py's looser bound where a JAX gradient came
near 0), the same on every rank; and the placement: every rank's shard of
every initial parameter equals, bit for bit, the JAX array's shard on the
device at the same mesh coordinate.

Failure modes these cases name, each a wrong number without an error:
FSDP2 averages gradients over its mesh by default (the fsdp and tp_fsdp
grad norms then read 1/4 and 1/2 of JAX's); token counts summed over
tensor ranks as well as the batch group (tp's loss); a grad norm or loss
read from local shards before the reductions (every case's grad norm).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ray_tpu_torch.models import convert
from test_torch_train_step import (GNORM_RTOL, LOOSE_TOL, NEAR_ZERO_GRAD,
                                   PARAM_TOL)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
WORLD = 8
STEPS = 3
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def jax_tree(jx, **cfg):
    """The JAX GPT tiny's initial params (numpy leaves) in fp32."""
    from ray_tpu.models.gpt import GPTConfig, gpt_init
    jcfg = dataclasses.replace(GPTConfig.tiny(), dtype=jx.numpy.float32,
                               **cfg)
    tree = jx.tree_util.tree_map(np.asarray,
                                 gpt_init(jx.random.PRNGKey(0), jcfg))
    return jcfg, tree


def tokens(rows, masked_rows, seq=33, seed=3):
    """[rows, seq] tokens with targets -1 from position 12 in the rows
    ``masked_rows`` (a slice) only."""
    toks = np.random.default_rng(seed).integers(0, 512, (rows, seq)).astype(
        np.int32)
    toks[masked_rows, 12:] = -1
    return toks


def launch(tmp_path, runs, arrays, world=WORLD, device="cpu", timeout=240):
    """Start ``world`` ranks of the worker on ``runs`` (its IN.npz format,
    arrays under their keys) and return each rank's OUT.npz as a dict."""
    inp = tmp_path / "in.npz"
    np.savez(inp, runs=json.dumps(runs), **arrays)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp_path / "store"),
         str(inp), str(tmp_path / f"out{r}.npz"), device], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]


def train_run(tag, strategy, mesh, cfg=None, accum=0, toks="tokens",
              params="param:"):
    return dict(tag=tag, strategy=strategy, mesh=mesh, cfg=cfg or {},
                accum_steps=accum, steps=STEPS, tokens=toks, params=params)


def jax_run(jx, jcfg, tree, toks, strategy, axes, loss_fn=None, accum=0):
    """JAX's sharded step on the 8-device CPU mesh (``accum`` microbatches
    on toks' leading dim): per step (loss, grad_norm, the whole-batch
    gradients), the final params, the eval loss, and {name: [the initial
    shard on device r for each r]}."""
    import jax
    import jax.numpy as jnp
    import optax
    from ray_tpu.models.gpt import gpt_loss
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.train.train_step import init_train_state, make_train_step
    devices = jax.devices()[:WORLD]
    mesh = build_mesh(MeshConfig(**axes), devices=devices)
    if loss_fn is None:
        loss_fn = lambda p, b: gpt_loss(p, b, jcfg)  # noqa: E731
    opt = optax.adamw(3e-4)
    state = init_train_state(lambda: jax.tree_util.tree_map(jnp.asarray, tree),
                             opt, mesh, strategy)
    shards = {}
    for name, arr in convert.flatten(state.params).items():
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        shards[name] = [by_dev[d] for d in devices]
    step = make_train_step(loss_fn, opt, mesh, strategy, accum_steps=accum,
                           sample_params=state.params, donate=False)
    micro = toks if accum else toks[None]
    grad = jax.jit(lambda p: jax.tree_util.tree_map(
        lambda *g: sum(g) / len(g),
        *[jax.grad(loss_fn)(p, {"tokens": mb}) for mb in micro]))
    batch = {"tokens": jnp.asarray(toks)}
    steps = []
    for _ in range(STEPS):
        g = convert.flatten(jax.tree_util.tree_map(np.asarray,
                                                   grad(state.params)))
        state, m = step(state, batch)
        steps.append((float(m["loss"]), float(m["grad_norm"]), g))
    final = convert.flatten(jax.tree_util.tree_map(np.asarray, state.params))
    flat = {"tokens": jnp.asarray(micro.reshape(-1, toks.shape[-1]))}
    return steps, final, float(loss_fn(state.params, flat)), shards


def assert_matches(ranks, tag, j_steps, j_final, j_eval, j_shards):
    """Every rank's losses, grad norms, eval loss, gathered final params and
    initial shards against JAX's (module doc's bounds)."""
    r0 = ranks[0]
    names = [k[len(tag) + 6:] for k in r0 if k.startswith(tag + "param:")]
    assert names
    for r, out in enumerate(ranks):
        for i, (jl, jn, _) in enumerate(j_steps):
            assert abs(float(out[tag + "loss"][i]) - jl) <= LOSS_RTOL * abs(
                jl), (tag, r, i, out[tag + "loss"][i], jl)
            assert abs(float(out[tag + "grad_norm"][i]) - jn) <= (
                GNORM_RTOL * abs(jn)), (tag, r, i, out[tag + "grad_norm"][i],
                                        jn)
        assert abs(float(out[tag + "eval_loss"]) - j_eval) <= (
            LOSS_RTOL * abs(j_eval)), (tag, r)
        for n in names:
            np.testing.assert_array_equal(out[f"{tag}shard:{n}"],
                                          j_shards[n][r], err_msg=n)
            np.testing.assert_array_equal(out[f"{tag}param:{n}"],
                                          r0[f"{tag}param:{n}"])
    assert r0[tag + "loss"][-1] < r0[tag + "loss"][0]
    n_loose = n_total = 0
    for n in names:
        near = np.zeros(j_final[n].shape, bool)
        for _, _, g in j_steps:
            near |= (g[n] != 0) & (np.abs(g[n]) < NEAR_ZERO_GRAD)
        err = np.abs(r0[f"{tag}param:{n}"] - j_final[n])
        assert err[~near].max(initial=0.0) <= PARAM_TOL, (tag, n)
        assert err[near].max(initial=0.0) <= LOOSE_TOL, (tag, n)
        n_loose += int(near.sum())
        n_total += near.size
    assert n_loose <= 1e-3 * n_total, (n_loose, n_total)


# tests/test_parallel.py::TestTrainStep::test_strategies_train's matrix;
# the rows of the masked coordinate of the batch axes (two rows each).
MATRIX = [
    ("dp", dict(data=8), slice(2, 4)),
    ("fsdp", dict(data=2, fsdp=4), slice(2, 4)),
    ("tp", dict(data=2, tensor=4), slice(8, 16)),
    ("tp_fsdp", dict(data=2, fsdp=2, tensor=2), slice(2, 4)),
]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("strategy,axes,masked", MATRIX,
                         ids=[m[0] for m in MATRIX])
def test_strategy_matches_jax_sharded_step(jx, tmp_path, strategy, axes,
                                           masked):
    jcfg, tree = jax_tree(jx)
    toks = tokens(16, masked)
    arrays = {"tokens": toks, **{f"param:{k}": v for k, v in
                                 convert.flatten(tree).items()}}
    ranks = launch(tmp_path, [train_run("", strategy, axes)], arrays)
    assert_matches(ranks, "", *jax_run(jx, jcfg, tree, toks, strategy, axes))
