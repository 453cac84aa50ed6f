"""Parity: ray_tpu_torch.parallel.pipeline against ray_tpu.parallel.pipeline,
for tests/test_pipeline.py's cases (loss and grads against the dense model,
pp and pp_tp, the param round trip, training steps) and the four raises.

Eight gloo ranks on the CPU (tests/torch_dp_worker.py, which imports no
JAX), one launch for every mesh, run the port's GPipe schedule, one process
per stage, through build_mesh -> init_train_state(..., mesh, "pp" |
"pp_tp") -> make_train_step(make_gpt_pp_loss(...)), three AdamW(3e-4)
steps of tests/test_pipeline.py's config (vocab 256, d 64, 4 layers, 4
heads) in fp32 on [8, 33] tokens, the global batch on every rank. JAX runs
make_gpt_pp_loss on the same mesh of the conftest's 8 CPU devices. Targets
are -1 from position 12 in two rows of the first data shard, so that a
count taken per shard or per stage would differ from the whole batch's.

Held, on every rank, against JAX's pp on the same mesh:
- the loss of each step (2e-5) and its grad norm (1e-4, relative);
- the gradients AdamW is given, this rank's shards, against JAX's gradient
  at the same place (2e-4), and against the dense model's (2e-4);
- every rank's initial shards, bit for bit; its stepped shards (2e-5; an
  element whose JAX gradient came near 0, 0 < |g| < 1e-7 at some step, to
  tests/test_torch_train_step.py's LOOSE_TOL, for the reason given there,
  and no more than 0.1% of them); the eval loss (2e-5).

The loss of step 0 is also held to JAX's dense gpt_loss (2e-5): in fp32,
JAX's pp equals the dense loss to 5e-7 on these meshes.

Failure modes these cases name: the embedding, final norm and head summed
over 'data' but not 'pipeline' (their gradients then hold one stage's
part); a per-stage or per-shard token count; a P2P order that differs
between the two ends of a pair (a deadlock, which the launch's time limit
turns into a failure).
"""


import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from test_torch_strategies import jax_run, launch, train_run
from test_torch_train_step import GNORM_RTOL, LOOSE_TOL, NEAR_ZERO_GRAD

CFG = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4, d_ff=128,
           max_seq=64, attention="reference", remat=False)
LOSS_TOL = 2e-5
GRAD_TOL = 2e-4

# (strategy, mesh, microbatches, GPTConfig fields over CFG): the meshes of
# tests/test_pipeline.py (data=2 x pipeline=4 with 2 and with 4
# microbatches, data=2 x pipeline=2 x tensor=2, and test_pp_tp_training_step's
# data=1 x pipeline=2 x tensor=2 x fsdp=2), flash attention (the plain
# kernels), and per-layer remat with the "pp" preset on a tensor axis
# (the stacked weights whole on each tensor rank, which the loss splits
# as JAX's does).
CASES = [
    ("pp", dict(data=2, pipeline=4), 2, {}),
    ("pp", dict(data=2, pipeline=4), 4, {}),
    ("pp_tp", dict(data=2, pipeline=2, tensor=2), 2, {}),
    ("pp_tp", dict(data=1, pipeline=2, tensor=2, fsdp=2), 2, {}),
    ("pp", dict(data=2, pipeline=4), 2, dict(attention="flash")),
    ("pp", dict(data=2, pipeline=2, tensor=2), 2, dict(remat=True)),
]
IDS = ["pp-d2p4", "pp-d2p4-m4", "pp_tp-d2p2t2", "pp_tp-d1p2t2f2",
       "pp-flash", "pp-d2p2t2-remat"]


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _jax_cfg(jx, **over):
    from ray_tpu.models.gpt import GPTConfig
    return GPTConfig(dtype=jx.numpy.float32, **{**CFG, **over})


@pytest.fixture(scope="module")
def env(jx, tmp_path_factory):
    """JAX's initial params (numpy), the tokens, the dense loss and grads,
    and every rank's output of one launch over all CASES."""
    import jax
    from ray_tpu.models.gpt import gpt_init, gpt_loss
    from ray_tpu.parallel.pipeline import gpt_params_to_pp
    jcfg = _jax_cfg(jx)
    tree = jax.tree_util.tree_map(np.asarray,
                                  gpt_init(jax.random.PRNGKey(0), jcfg))
    pp_tree = jax.tree_util.tree_map(np.asarray, gpt_params_to_pp(tree))
    toks = np.random.RandomState(0).randint(0, 256, (8, 33)).astype(np.int32)
    toks[2:4, 12:] = -1
    loss, grads = jax.value_and_grad(lambda p: gpt_loss(
        p, {"tokens": toks}, jcfg))(tree)
    dense_grads = convert.flatten(jax.tree_util.tree_map(
        np.asarray, gpt_params_to_pp(grads)))
    runs = [dict(train_run(f"{i}/", s, mesh, {**CFG, **cfg}),
                 microbatches=m, grads=True)
            for i, (s, mesh, m, cfg) in enumerate(CASES)]
    arrays = {"tokens": toks, **{f"param:{k}": v for k, v in
                                 convert.flatten(pp_tree).items()}}
    ranks = launch(tmp_path_factory.mktemp("pp"), runs, arrays)
    return dict(pp_tree=pp_tree, toks=toks, dense_loss=float(loss),
                dense_grads=dense_grads, ranks=ranks)


def _slice(name, full, strategy, axes, rank):
    """The part of ``full`` that rank ``rank`` holds under ``strategy``."""
    from ray_tpu_torch.parallel import fake_mesh
    from ray_tpu_torch.parallel.sharding import Placement, strategy_from_name
    mesh = fake_mesh(8, **axes)
    mesh.rank = rank
    specs = strategy_from_name(strategy).param_specs(mesh, {name: full})
    return Placement(mesh, {name: specs[name.replace(".", "/")]}).local(
        name, torch.from_numpy(np.array(full))).numpy()


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_pp_matches_jax(jx, env, case):
    import jax
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.parallel.pipeline import make_gpt_pp_loss
    strategy, axes, micro, over = CASES[case]
    tag = f"{case}/"
    jcfg = _jax_cfg(jx, **over)
    mesh = build_mesh(MeshConfig(**axes), devices=jax.devices()[:8])
    loss_fn = make_gpt_pp_loss(jcfg, mesh, num_microbatches=micro)
    j_steps, j_final, j_eval, j_shards = jax_run(
        jx, jcfg, env["pp_tree"], env["toks"], strategy, axes,
        loss_fn=loss_fn)
    ranks = env["ranks"]
    r0 = ranks[0]
    names = [k[len(tag) + 6:] for k in r0 if k.startswith(tag + "param:")]
    assert len(names) == 12
    assert abs(j_steps[0][0] - env["dense_loss"]) <= LOSS_TOL
    for r, out in enumerate(ranks):
        loss, norm = out[tag + "loss"], out[tag + "grad_norm"]
        assert abs(float(loss[0]) - env["dense_loss"]) <= LOSS_TOL, (r, loss)
        assert abs(float(out[tag + "eval_loss"]) - j_eval) <= LOSS_TOL, r
        for i, (jl, jn, jg) in enumerate(j_steps):
            assert abs(float(loss[i]) - jl) <= LOSS_TOL, (r, i, loss[i], jl)
            assert abs(float(norm[i]) - jn) <= GNORM_RTOL * jn, (r, i)
            for n in names:
                got = out[f"{tag}grad{i}:{n}"]
                err = np.abs(got - _slice(n, jg[n], strategy, axes, r)).max()
                assert err <= GRAD_TOL, (r, i, n, err)
                if i == 0:
                    err = np.abs(got - _slice(n, env["dense_grads"][n],
                                              strategy, axes, r)).max()
                    assert err <= GRAD_TOL, ("dense", r, n, err)
        for n in names:
            np.testing.assert_array_equal(out[f"{tag}shard:{n}"],
                                          j_shards[n][r], err_msg=n)
            np.testing.assert_array_equal(out[f"{tag}param:{n}"],
                                          r0[f"{tag}param:{n}"], err_msg=n)
            near = np.zeros(j_final[n].shape, bool)
            for _, _, g in j_steps:
                near |= (g[n] != 0) & (np.abs(g[n]) < NEAR_ZERO_GRAD)
            near = _slice(n, near, strategy, axes, r)
            err = np.abs(out[f"{tag}final:{n}"]
                         - _slice(n, j_final[n], strategy, axes, r))
            assert err[~near].max(initial=0.0) <= LOSS_TOL, (r, n)
            assert err[near].max(initial=0.0) <= LOOSE_TOL, (r, n)
            assert near.sum() <= 1e-3 * near.size, (r, n, near.sum())
    assert r0[tag + "loss"][-1] < r0[tag + "loss"][0]


def test_pp_round_trip_params(jx):
    """gpt_params_to_pp / pp_params_to_gpt: the port's tree conversion
    equals JAX's leaf for leaf, the module's names are JAX's stacked paths,
    and both round trips give the params back bit for bit."""
    import jax
    from ray_tpu.models.gpt import gpt_init
    from ray_tpu.parallel import pipeline as jpp

    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.parallel import pipeline as tpp
    jcfg = _jax_cfg(jx)
    tree = jax.tree_util.tree_map(np.asarray,
                                  gpt_init(jax.random.PRNGKey(0), jcfg))
    want = convert.flatten(jax.tree_util.tree_map(
        np.asarray, jpp.gpt_params_to_pp(tree)))
    got = convert.flatten(tpp.gpt_params_to_pp(tree))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = convert.flatten(tpp.pp_params_to_gpt(tpp.gpt_params_to_pp(tree),
                                                jcfg.n_layers))
    flat = convert.flatten(tree)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)

    tcfg = tgpt.GPTConfig(dtype=torch.float32, **CFG)
    model = tgpt.gpt_init(tcfg, device="cpu")
    convert.load_params(model, tree)
    stacked = tpp.gpt_params_to_pp(model)
    names = [n for n, _ in stacked.named_parameters()]
    assert sorted(names) == sorted(want)
    for n, p in stacked.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)
    again = tpp.pp_params_to_gpt(stacked, tcfg.n_layers)
    for (n, a), b in zip(again.named_parameters(), model.parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("over,axes,rows,match", [
    (dict(n_layers=3), dict(pipeline=4), 8,
     r"n_layers=3 not divisible by pipeline=4"),
    (dict(n_experts=4), dict(pipeline=4), 8,
     r"pipeline preset supports dense MLP layers"),
    (dict(n_heads=4), dict(tensor=8), 8,
     r"n_heads=4 not divisible by tp=8"),
    ({}, {}, 6, r"per-shard batch 6 not divisible by microbatches 4"),
], ids=["layers", "moe", "heads", "batch"])
def test_pp_loss_raises_as_jax(jx, over, axes, rows, match):
    """make_gpt_pp_loss raises JAX's four ValueErrors, with its messages:
    three when it is built, the batch's when it runs (one process,
    pipeline=1, 6 rows for 4 microbatches)."""
    import jax
    from ray_tpu.models.gpt import gpt_init
    from ray_tpu.parallel import pipeline as jpp
    from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from ray_tpu.parallel.mesh import build_mesh as jbuild_mesh

    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.parallel import MeshConfig, build_mesh, fake_mesh
    from ray_tpu_torch.parallel import pipeline as tpp
    toks = np.random.default_rng(0).integers(0, 256, (rows, 33))
    jcfg = _jax_cfg(jx, **over)
    n = int(np.prod(list(axes.values()))) if axes else 1
    jmesh = jbuild_mesh(JMeshConfig(data=1, **axes),
                        devices=jax.devices()[:n])
    with pytest.raises(ValueError, match=match):
        loss = jpp.make_gpt_pp_loss(jcfg, jmesh, num_microbatches=4)
        loss(jpp.gpt_params_to_pp(gpt_init(jax.random.PRNGKey(0), jcfg)),
             {"tokens": toks})
    tcfg = tgpt.GPTConfig(dtype=torch.float32, **{**CFG, **over})
    if axes:
        with pytest.raises(ValueError, match=match):
            tpp.make_gpt_pp_loss(tcfg, fake_mesh(n, data=1, **axes), 4)
        return
    mesh = build_mesh(MeshConfig(data=1), devices=["cpu"])
    loss = tpp.make_gpt_pp_loss(tcfg, mesh, 4)
    with pytest.raises(ValueError, match=match):
        loss(tpp.gpt_params_to_pp(tgpt.gpt_init(tcfg, device="cpu")),
             {"tokens": torch.from_numpy(toks)})
