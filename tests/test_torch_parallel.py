"""Parity: ray_tpu_torch.parallel (mesh and sharding rules) against
ray_tpu.parallel.

Mesh: MeshConfig.axis_sizes and from_dict, results and error messages,
and build_mesh's shapes, layout and under-subscription warning, for the
cases of tests/test_parallel.py::TestMesh and a few more, on the JAX
package's 8-device CPU mesh and the port's fake_mesh / build_mesh over
CPU devices. Sharding: every preset's spec of every GPT parameter, dense
and MoE, against JAX's ``strategy.param_shardings(mesh, params)``, on the
meshes of tests/test_parallel.py::TestShardingRules and two more; and the
batch and activation specs. Specs compare as tuples: a JAX PartitionSpec
is a tuple of the same entries.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh

PRESETS = ["dp", "fsdp", "tp", "tp_fsdp", "sp", "pp", "pp_tp"]
MESHES = [dict(data=2, tensor=4), dict(data=2, fsdp=4),
          dict(data=2, fsdp=2, tensor=2), dict(data=2, expert=4)]


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _outcome(fn):
    """("ok", value) or (exception type name, message)."""
    try:
        return "ok", fn()
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("axes,n", [
    (dict(data=2, fsdp=2, tensor=2), 8),
    (dict(tensor=4), 8),                    # data = the rest
    (dict(data=1), 1),
    (dict(data=2, tensor=2), 8),            # under-subscribed: 4 of 8
    (dict(data=3, tensor=3), 8),            # bad factorization
    (dict(tensor=3), 8),                    # rest not divisible
    (dict(data=-1, fsdp=-1), 8),            # two axes -1
])
def test_axis_sizes_match_jax(axes, n):
    from ray_tpu.parallel.mesh import MeshConfig
    assert _outcome(lambda: tmesh.MeshConfig(**axes).axis_sizes(n)) == \
        _outcome(lambda: MeshConfig(**axes).axis_sizes(n))


@pytest.mark.parametrize("d", [dict(data=2, tensor=4), dict(expert=8),
                               dict(tensor=2, bogus=1, other=3)])
def test_from_dict_matches_jax(d):
    from ray_tpu.parallel.mesh import MeshConfig
    assert _outcome(lambda: dataclasses.asdict(tmesh.MeshConfig.from_dict(
        d))) == _outcome(lambda: dataclasses.asdict(MeshConfig.from_dict(d)))


@pytest.mark.parametrize("axes", [dict(data=2, fsdp=2, tensor=2),
                                  dict(tensor=4), dict(data=3, tensor=3),
                                  dict(data=2, expert=2, sequence=2)])
def test_build_mesh_matches_jax(jx, axes):
    """Same shape (or the same error), and rank r sits where JAX puts
    device r."""
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    j = _outcome(lambda: build_mesh(MeshConfig(**axes)))
    t = _outcome(lambda: tmesh.build_mesh(tmesh.MeshConfig(**axes),
                                          devices=["cpu"] * 8))
    assert t[0] == j[0]
    if j[0] != "ok":
        assert t == j
        return
    jm, tm = j[1], t[1]
    assert tm.shape == dict(jm.shape)
    assert tm.size == len(jm.devices.flatten()) == 8
    assert tm.axis_names == tuple(jm.axis_names)
    for r, dev in enumerate(jx.devices()[:8]):
        tm.rank = r
        assert tuple(tm.coordinate().values()) == tuple(
            int(i) for i in np.argwhere(jm.devices == dev)[0])
        assert tm.device == torch.device("cpu")


def test_under_subscription_warns_as_jax(jx, caplog):
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    with caplog.at_level(logging.WARNING):
        build_mesh(MeshConfig(data=2, tensor=2))
        mesh = tmesh.build_mesh(tmesh.MeshConfig(data=2, tensor=2),
                                devices=["cpu"] * 8)
    msgs = [r.getMessage() for r in caplog.records if "idle" in r.getMessage()]
    assert len(msgs) == 2 and msgs[0] == msgs[1], msgs
    assert mesh.size == 4


def test_fake_mesh_and_default_device(monkeypatch):
    """fake_mesh lays CPU devices out with no process group; build_mesh's
    default is the card, and raises without one."""
    m = tmesh.fake_mesh(8, data=2, tensor=4)
    assert m.shape["data"] == 2 and m.shape["tensor"] == 4
    assert m.device_mesh is None and m.group("fsdp") is None
    with pytest.raises(ValueError, match="no process group"):
        m.group("tensor")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.build_mesh(tmesh.MeshConfig(data=1))


def _gpt_shapes(jx, n_experts):
    """{dotted name: shape} of the JAX GPT tiny params."""
    from ray_tpu.models.gpt import GPTConfig, gpt_init
    from ray_tpu_torch.models import convert
    cfg = dataclasses.replace(GPTConfig.tiny(), n_experts=n_experts)
    sample = jx.eval_shape(lambda: gpt_init(jx.random.PRNGKey(0), cfg))
    return cfg, sample, {n: tuple(x.shape) for n, x in
                         convert.flatten(sample).items()}


@pytest.mark.parametrize("n_experts", [0, 4], ids=["dense", "moe"])
@pytest.mark.parametrize("preset", PRESETS)
def test_param_specs_match_jax(jx, preset, n_experts):
    """Every GPT parameter's spec under ``preset``, on each mesh, equals
    the spec of JAX's param_shardings; the port module's own parameters
    give the same table."""
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.parallel.sharding import strategy_from_name
    from ray_tpu_torch.models import convert
    cfg, sample, shapes = _gpt_shapes(jx, n_experts)
    model = tgpt.gpt_init(dataclasses.replace(
        tgpt.GPTConfig.tiny(), n_experts=n_experts), device="cpu")
    for axes in MESHES:
        jsh = strategy_from_name(preset).param_shardings(
            build_mesh(MeshConfig(**axes)), sample)
        jspecs = {n.replace(".", "/"): tuple(s.spec) for n, s in
                  convert.flatten(jsh).items()}
        strategy = tsh.strategy_from_name(preset)
        mesh = tmesh.fake_mesh(8, **axes)
        assert strategy.param_specs(mesh, model) == jspecs, axes
        assert strategy.param_specs(
            mesh, {n: torch.empty(s) for n, s in shapes.items()}) == jspecs
    if preset == "tp" and n_experts:
        assert jspecs["layers/0/moe/w_up"] == ("expert", None, "tensor")


def test_fsdp_shards_largest_dim_as_jax(jx):
    """tests/test_parallel.py::TestShardingRules::test_fsdp_shards_largest_dim,
    both ways: (128, 64) on its largest dim, (7,) replicated."""
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.parallel.sharding import ShardingStrategy
    params = {"w": np.zeros((128, 64)), "b": np.zeros((7,))}
    jsh = ShardingStrategy.fsdp().param_shardings(
        build_mesh(MeshConfig(data=2, fsdp=4)), params)
    specs = tsh.ShardingStrategy.fsdp().param_specs(
        tmesh.fake_mesh(8, data=2, fsdp=4), params)
    assert specs == {k: tuple(v.spec) for k, v in jsh.items()}
    assert specs == {"w": ("fsdp", None), "b": ()}


@pytest.mark.parametrize("preset", PRESETS)
def test_batch_and_activation_specs_match_jax(preset):
    from ray_tpu.parallel.sharding import strategy_from_name
    j, t = strategy_from_name(preset), tsh.strategy_from_name(preset)
    assert t.name == j.name
    assert t.batch_spec == tuple(j.batch_spec)
    assert t.activation_spec == tuple(j.activation_spec)
    assert t.data_axes == j.data_axes


def test_unknown_strategy_matches_jax():
    from ray_tpu.parallel.sharding import strategy_from_name
    assert _outcome(lambda: tsh.strategy_from_name("zero3")) == \
        _outcome(lambda: strategy_from_name("zero3"))


@pytest.mark.parametrize("spec,shape", [
    (("fsdp", "tensor"), (8,)), ((None, "tensor"), (4, 8, 16)),
    (("tensor",), ()), ((), (3, 5))])
def test_truncate_spec_matches_jax(spec, shape):
    from jax.sharding import PartitionSpec as P
    from ray_tpu.parallel.sharding import _truncate_spec
    assert tsh._truncate_spec(spec, shape) == tuple(
        _truncate_spec(P(*spec), shape))


@pytest.mark.parametrize("axes,preset,n_experts,match", [
    (dict(tensor=3), "tp", 0,
     r"lm_head: dim 1 of size 512 does not divide over the tensor axis"
     r" \(3\)"),
    (dict(tensor=8), "tp", 0,
     r"attn/wq: 4 heads do not divide over the 'tensor' axis \(8\)"),
    (dict(expert=8), "tp", 4,
     r"layers.0.moe.w_up: dim 0 of size 4 does not divide over the expert "
     r"axis \(8\)"),
    (dict(fsdp=3, tensor=2), "tp_fsdp", 0,
     r"lm_head: dim 0 of size 128 does not divide over the fsdp axis "
     r"\(3\)"),
])
def test_indivisible_placement_raises(axes, preset, n_experts, match):
    """A tensor or expert axis that does not divide a dim (or the heads)
    raises ValueError naming the parameter and the axis; the port never
    falls back to replication there."""
    cfg = dataclasses.replace(tgpt.GPTConfig.tiny(), n_experts=n_experts)
    mesh = tmesh.fake_mesh(int(np.prod(list(axes.values()))), **axes)
    model = tgpt.gpt_init(cfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        tsh.shard_params(model, mesh, preset)


def test_fsdp_largest_replicates_where_nothing_divides():
    """JAX's FSDP_LARGEST replicates a parameter that no dim of divides:
    on fsdp=3 every GPT-tiny weight stays whole, with no FSDP2 module."""
    mesh = tmesh.fake_mesh(3, fsdp=3)
    model = tgpt.gpt_init(tgpt.GPTConfig.tiny(), device="cpu")
    shapes = {n: p.shape for n, p in model.named_parameters()}
    placement = tsh.shard_params(model, mesh, "fsdp")
    assert not placement.fsdp and model.placement is placement
    assert all(spec == () for spec in placement.specs.values())
    assert {n: p.shape for n, p in model.named_parameters()} == shapes


def test_tensor_slices_are_the_spec_parts():
    """Rank r's slice under "tp" on a fake mesh (no process group needed:
    tensor and expert slices are local) is the spec's part of the whole
    parameter at r's coordinate."""
    cfg = dataclasses.replace(tgpt.GPTConfig.tiny(), n_experts=4)
    whole = tgpt.gpt_init(cfg, device="cpu")
    full = {n: p.detach().clone() for n, p in whole.named_parameters()}
    mesh = tmesh.fake_mesh(8, data=2, tensor=2, expert=2)
    mesh.rank = 7                                   # tensor 1, expert 1
    tsh.shard_params(whole, mesh, "tp")
    got = dict(whole.named_parameters())
    assert torch.equal(got["layers.0.attn.wq"], full["layers.0.attn.wq"][:, 64:])
    assert torch.equal(got["layers.0.attn.wo"], full["layers.0.attn.wo"][64:])
    assert torch.equal(got["embed.table"], full["embed.table"][256:])
    assert torch.equal(got["lm_head"], full["lm_head"][:, 256:])
    assert torch.equal(got["layers.1.moe.w_up"],
                       full["layers.1.moe.w_up"][2:, :, 128:])
    assert torch.equal(got["layers.1.moe.w_down"],
                       full["layers.1.moe.w_down"][2:, 128:])
    # No rule matches moe/w_gate: whole on every rank, used in part.
    assert torch.equal(got["layers.1.moe.w_gate"], full["layers.1.moe.w_gate"])
    assert torch.equal(got["layers.1.ln1.scale"], full["layers.1.ln1.scale"])
    with pytest.raises(ValueError, match="placed already"):
        tsh.shard_params(whole, mesh, "tp")


@pytest.mark.parametrize("rule,match", [
    ((r"attn/wq", ("tensor", None)),
     r"layers.0.attn.wq: split over 'tensor' on dim 0, where its block "
     r"splits dim 1"),
    ((r"ln1", ("tensor",)),
     r"layers.0.ln1.scale: split over 'tensor' on dim 0, where its block "
     r"splits none"),
    ((r"attn/wq", ("tensor", "tensor")),
     r"layers.0.attn.wq: spec \('tensor', 'tensor'\) names an axis twice"),
])
def test_misplaced_split_raises(rule, match):
    """A spec that splits a weight on a dim its block does not split, or
    names an axis twice, raises ValueError at placement, naming the
    parameter: the model runs each block on the dims that the placement
    gives it (GPT.check_placement, Placement.check)."""
    mesh = tmesh.fake_mesh(2, tensor=2)
    model = tgpt.gpt_init(tgpt.GPTConfig.tiny(), device="cpu")
    strategy = tsh.ShardingStrategy(
        "custom", tsh.ShardingRules(rules=[rule], default=()), ("data",))
    with pytest.raises(ValueError, match=match):
        tsh.shard_params(model, mesh, strategy)


def test_sp_ep_specs():
    """ShardingStrategy.sp_ep (the JAX dry run's strategy): experts over
    'expert', the router and everything else replicated, rows over
    'data'."""
    cfg = dataclasses.replace(tgpt.GPTConfig.tiny(), n_experts=4)
    mesh = tmesh.fake_mesh(8, data=2, sequence=2, expert=2)
    strategy = tsh.ShardingStrategy.sp_ep()
    specs = strategy.param_specs(mesh, tgpt.gpt_init(cfg, device="cpu"))
    split = {p for p, s in specs.items() if s != () and set(s) != {None}}
    assert split == {f"layers/{i}/moe/{w}" for i in range(cfg.n_layers)
                     for w in ("w_gate", "w_up", "w_down")}
    assert all(specs[p] == ("expert", None, None) for p in split)
    assert strategy.batch_spec == ("data",)
