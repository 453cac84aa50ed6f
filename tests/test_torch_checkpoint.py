"""Parity: ray_tpu_torch.train.checkpoint against ray_tpu.train.checkpoint.

Gloo ranks on the CPU (tests/torch_dp_worker.py) save and restore; the
JAX package's save_pytree writes the same trees from the conftest's 8 CPU
devices (one process, so one ``.h0.npz`` holding every shard).

- tests/test_train.py::test_save_load_pytree_sharded on four ranks: a
  [8, 4] DTensor sharded on dim 0, a whole tensor and a plain value, loaded
  whole and resharded onto dim 1; the union of the four files' entries
  equals JAX's file, key for key and byte for byte.
- A tp_fsdp TrainState (data=2 x fsdp=2 x tensor=2, GPTConfig.tiny() in
  fp32) on eight ranks: at step 0 its entries and index equal those JAX's
  save_pytree writes for JAX's tp_fsdp state from the same weights. Saved
  after two steps, it restores under fsdp (data=2 x fsdp=4) on the eight
  ranks and in this one process; the next step equals the uninterrupted
  run's third step and JAX's (loss 2e-5; parameters 2e-5, with Adam's
  near-zero exception of tests/test_torch_train_step.py).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from test_torch_strategies import jax_run, jax_tree, launch, tokens, train_run
from test_torch_train_step import LOOSE_TOL, NEAR_ZERO_GRAD

TOL = 2e-5


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _entries(directory, name="state"):
    """{key: array} of every process's file of a checkpoint."""
    out = {}
    for fn in sorted(os.listdir(directory)):
        if fn.startswith(name + ".h") and fn.endswith(".npz"):
            with np.load(os.path.join(directory, fn)) as z:
                for key in z.files:
                    assert key not in out, f"{key} written twice"
                    out[key] = z[key]
    return out


def _assert_same_entries(port_dir, jax_dir):
    got, want = _entries(port_dir), _entries(jax_dir)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with open(os.path.join(port_dir, "state.index.json")) as f:
        got_index = json.load(f)
    with open(os.path.join(jax_dir, "state.index.json")) as f:
        assert got_index == json.load(f)


@pytest.mark.timeout(240)
def test_save_load_pytree_sharded(jx, tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ray_tpu.train import save_pytree
    ranks = launch(tmp_path, [dict(kind="pytree", tag="", dir=str(
        tmp_path / "port"))], {}, world=4)
    full = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["w"], full)
        np.testing.assert_array_equal(out["b"], np.ones(3, np.float32))
        assert int(out["step"]) == 7
        np.testing.assert_array_equal(out["w_local"], full[:, r:r + 1])
        np.testing.assert_array_equal(out["w_full"], full)
        np.testing.assert_array_equal(out["b_local"], np.ones(3))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("fsdp",))
    tree = {"w": jax.device_put(jnp.arange(32.0).reshape(8, 4),
                                NamedSharding(mesh, P("fsdp", None))),
            "b": jnp.ones(3), "meta": {"step": 7}}
    save_pytree(tree, str(tmp_path / "jax"))
    _assert_same_entries(tmp_path / "port", tmp_path / "jax")


def _near(j_steps, name):
    near = 0
    for _, _, g in j_steps:
        near = near | ((g[name] != 0) & (np.abs(g[name]) < NEAR_ZERO_GRAD))
    return near


def _assert_params(got, want, j_steps, label):
    for n, w in want.items():
        err = np.abs(got[n] - w)
        near = _near(j_steps, n)
        assert err[~near].max(initial=0.0) <= TOL, (label, n)
        assert err[near].max(initial=0.0) <= LOOSE_TOL, (label, n)


@pytest.mark.timeout(300)
def test_tp_fsdp_state_saves_as_jax_and_restores(jx, tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.train import save_pytree
    from ray_tpu.train.train_step import init_train_state

    from ray_tpu_torch.models import GPTConfig, gpt_init, gpt_loss
    from ray_tpu_torch.train import adamw, load_pytree, make_train_step
    from ray_tpu_torch.train import init_train_state as t_init
    jcfg, tree = jax_tree(jx)
    toks = tokens(16, slice(2, 4))
    saved = {"0": str(tmp_path / "step0"), "2": str(tmp_path / "step2")}
    axes = dict(data=2, fsdp=2, tensor=2)
    runs = [dict(train_run("a/", "tp_fsdp", axes), saves=saved),
            dict(train_run("b/", "fsdp", dict(data=2, fsdp=4)), steps=1,
                 restore=saved["2"])]
    arrays = {"tokens": toks, **{f"param:{k}": v for k, v in
                                 convert.flatten(tree).items()}}
    ranks = launch(tmp_path, runs, arrays)

    # Step 0 as JAX writes it.
    mesh = build_mesh(MeshConfig(**axes), devices=jax.devices()[:8])
    state = init_train_state(lambda: jax.tree_util.tree_map(jnp.asarray, tree),
                             optax.adamw(3e-4), mesh, "tp_fsdp")
    save_pytree(state, str(tmp_path / "jax0"))
    _assert_same_entries(saved["0"], tmp_path / "jax0")
    with open(os.path.join(saved["0"], "state.leaves.json")) as f:
        paths = json.load(f)
    # JAX's TrainState node numbers its children: params, opt_state, step.
    names = {"0": "params", "1": "opt_state", "2": "step"}
    want = []
    for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]:
        head, _, rest = jax.tree_util.keystr(
            p, simple=True, separator="/").partition("/")
        want.append("/".join([names[head]] + ([rest] if rest else [])))
    assert paths == want

    # The restored step against the uninterrupted third step and JAX's.
    j_steps, j_final, _, _ = jax_run(jx, jcfg, tree, toks, "tp_fsdp", axes)
    a = ranks[0]
    names = [k[len("a/param:"):] for k in a if k.startswith("a/param:")]
    uninterrupted = {n: a[f"a/param:{n}"] for n in names}
    for r, out in enumerate(ranks):
        assert abs(out["b/loss"][0] - a["a/loss"][2]) <= TOL, r
        assert abs(out["b/loss"][0] - j_steps[2][0]) <= TOL, r
        restored = {n: out[f"b/param:{n}"] for n in names}
        _assert_params(restored, uninterrupted, j_steps, f"fsdp rank {r}")
        _assert_params(restored, j_final, j_steps, f"fsdp rank {r} vs JAX")
    # One process, no mesh: the whole state.
    cfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32)
    opt = adamw(3e-4)
    one = t_init(lambda: gpt_init(cfg, device="cpu"), opt)
    one = load_pytree(saved["2"], state=one)
    assert one.step == 2 and one.opt_state.count == 2
    one, metrics = make_train_step(gpt_loss, opt)(
        one, {"tokens": torch.from_numpy(toks).long()})
    assert abs(float(metrics["loss"]) - a["a/loss"][2]) <= TOL
    got = {n: p.detach().numpy() for n, p in one.params.named_parameters()}
    _assert_params(got, uninterrupted, j_steps, "one process")
    whole = load_pytree(saved["2"])
    assert int(whole["step"]) == 2
    assert sorted(convert.flatten(whole["params"])) == sorted(
        convert.flatten(tree))
