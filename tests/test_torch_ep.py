"""Parity: the port's expert-parallel MoE and its sequence split against
ray_tpu's sharded steps on the same mesh.

Eight gloo ranks on the CPU (tests/torch_dp_worker.py), one launch per
mesh layout, three AdamW(3e-4) steps in fp32, unequal masks, the bounds
and checks of tests/test_torch_strategies.py (losses, grad norms, eval
loss, gathered final params, every rank's initial shards against JAX's):

- tests/test_parallel.py::TestTrainStep::test_moe_expert_parallel's case:
  "tp" (whose moe/ rules shard experts over 'expert') with 4 experts on
  data=2 x expert=4. No rule matches moe/w_gate, so every rank holds it
  whole and uses its experts' part: its gradient is summed over 'expert'.
- the same with tensor=2 x expert=2: experts over 'expert', d_ff over
  'tensor', w_gate used in part over both.
- __graft_entry__.py:dryrun_multichip's sp_ep leg: data=2 x sequence=2 x
  expert=2, ring attention, 2 experts, its rules (the port's
  ShardingStrategy.sp_ep, turned into JAX's for the reference); JAX
  splits the residual stream over 'sequence' by its activation
  constraint, the port after the embedding.
"""

import pytest

from ray_tpu_torch.models import convert
from ray_tpu_torch.parallel import ShardingStrategy as ShardingStrategy_port
from test_torch_strategies import (assert_matches, jax_run, jax_tree, launch,
                                   tokens, train_run)

MOE = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
           max_seq=64, n_experts=4)
SP_EP = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, d_ff=256,
             max_seq=64, attention="ring", n_experts=2)


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _arrays(tree, toks):
    return {"tokens": toks, **{f"param:{k}": v for k, v in
                               convert.flatten(tree).items()}}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("axes", [dict(data=2, expert=4),
                                  dict(data=2, tensor=2, expert=2)],
                         ids=["expert4", "tensor2_expert2"])
def test_moe_expert_parallel_matches_jax(jx, tmp_path, axes):
    jcfg, tree = jax_tree(jx, **MOE)
    toks = tokens(4, slice(2, 4))
    ranks = launch(tmp_path, [train_run("", "tp", axes, MOE)],
                   _arrays(tree, toks))
    assert_matches(ranks, "", *jax_run(jx, jcfg, tree, toks, "tp", axes))


def _jax_sp_ep(jx):
    """The port's ShardingStrategy.sp_ep() as a JAX strategy."""
    from jax.sharding import PartitionSpec as P
    from ray_tpu.parallel.sharding import ShardingRules, ShardingStrategy
    s = ShardingStrategy_port.sp_ep()
    return ShardingStrategy(s.name, ShardingRules(
        rules=[(r, P(*spec)) for r, spec in s.param_rules.rules],
        default=P(*s.param_rules.default)), P(*s.batch_spec))


def jax_sequence_loss(jx, jcfg, axes):
    """JAX's gpt_loss with the dry run's activation constraint: the residual
    stream split over data and sequence on the 8-device mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ray_tpu.models.gpt import gpt_loss
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    mesh = build_mesh(MeshConfig(**axes), devices=jx.devices()[:8])
    act = NamedSharding(mesh, P("data", "sequence", None))
    return lambda p, b: gpt_loss(p, b, jcfg, mesh=mesh, act_sharding=act)


@pytest.mark.timeout(300)
def test_sp_ep_matches_jax_dryrun_leg(jx, tmp_path):
    axes = dict(data=2, sequence=2, expert=2)
    jcfg, tree = jax_tree(jx, **SP_EP)
    toks = tokens(4, slice(2, 4), seq=65)
    ranks = launch(tmp_path, [train_run("", "sp_ep", axes, SP_EP)],
                   _arrays(tree, toks))
    assert_matches(ranks, "", *jax_run(
        jx, jcfg, tree, toks, _jax_sp_ep(jx), axes,
        loss_fn=jax_sequence_loss(jx, jcfg, axes)))
