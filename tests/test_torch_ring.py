"""Parity: the port's ring attention and sequence-parallel ("sp") step
against ray_tpu's.

- ``ring_attention`` over a sequence split 8 ways (8 gloo ranks, one
  launch of tests/torch_dp_worker.py), on
  tests/test_parallel.py::TestAttention::test_ring_attention_matches'
  inputs, (1, 2, 128, 16) fp32: the shards' outputs against JAX's
  ring_attention on the 8-device CPU mesh within 2e-5, and the gradients
  of sum(out * w) against those of JAX's mha_reference within 2e-4 (the
  bounds of TestAttention).
- ``ring_attention`` in one process (a ring of one: one local block)
  against mha_reference, forward and gradients, at the same bounds.
- the "sp" preset with attention="ring" on data=2 x sequence=4, three
  AdamW steps, against JAX's step with the same rules and the dry run's
  activation constraint (the residual stream split over data and
  sequence) on the same mesh, with tests/test_torch_strategies.py's bounds
  and checks. JAX's "sp" batch spec shards the tokens [B, S+1] themselves
  over 'sequence', which S+1 = 33 does not allow; the port splits the S
  inputs and targets after the embedding, as the dry run does.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.ops.attention import mha_reference, ring_attention
from test_torch_ep import jax_sequence_loss
from test_torch_strategies import (assert_matches, jax_run, jax_tree, launch,
                                   tokens, train_run)

FWD_TOL, GRAD_TOL = 2e-5, 2e-4


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _qkvw(jx):
    """test_ring_attention_matches' q, k, v, and a weight w for the
    gradients' loss sum(out * w)."""
    k1, k2, k3 = jx.random.split(jx.random.PRNGKey(3), 3)
    q, k, v = (np.array(jx.random.normal(key, (1, 2, 128, 16)))
               for key in (k1, k2, k3))
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    return q, k, v, w


def _jax_reference_grads(jx, q, k, v, w):
    from ray_tpu.ops.attention import mha_reference as jref
    return jx.grad(lambda q, k, v: (jref(q, k, v, causal=True) * w).sum(),
                   argnums=(0, 1, 2))(q, k, v)


@pytest.mark.timeout(300)
def test_ring_attention_over_8_ranks_matches_jax(jx, tmp_path):
    from ray_tpu.ops.attention import ring_attention as jring
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    q, k, v, w = _qkvw(jx)
    ranks = launch(tmp_path, [dict(tag="", kind="ring", mesh={"sequence": 8},
                                   q="q", k="k", v="v", w="w")],
                   dict(q=q, k=k, v=v, w=w))
    got = {key: np.concatenate([r[key] for r in ranks], axis=2)
           for key in ("out", "dq", "dk", "dv")}
    mesh = build_mesh(MeshConfig(data=1, sequence=8),
                      devices=jx.devices()[:8])
    ref = np.asarray(jring(q, k, v, mesh=mesh, causal=True))
    assert np.abs(got["out"] - ref).max() < FWD_TOL
    for name, g in zip("qkv", _jax_reference_grads(jx, q, k, v, w)):
        assert np.abs(got["d" + name] - np.asarray(g)).max() < GRAD_TOL, name


def test_ring_of_one_is_one_block(jx):
    q, k, v, w = _qkvw(jx)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ring_attention(*t, causal=True)
    ref = mha_reference(*(x.detach() for x in t), causal=True)
    assert float((out - ref).detach().abs().max()) < FWD_TOL
    torch.sum(out * torch.from_numpy(w)).backward()
    for x, g in zip(t, _jax_reference_grads(jx, q, k, v, w)):
        assert float((x.grad - torch.from_numpy(np.array(g))).abs().max()
                     ) < GRAD_TOL


@pytest.mark.timeout(300)
def test_sp_matches_jax_sequence_split(jx, tmp_path):
    axes = dict(data=2, sequence=4)
    jcfg, tree = jax_tree(jx, attention="ring")
    toks = tokens(4, slice(2, 4))
    arrays = {"tokens": toks, **{f"param:{k}": v for k, v in
                                 convert.flatten(tree).items()}}
    ranks = launch(tmp_path, [train_run("", "sp", axes,
                                        {"attention": "ring"})], arrays)
    assert_matches(ranks, "", *jax_run(
        jx, jcfg, tree, toks, "dp", axes,
        loss_fn=jax_sequence_loss(jx, jcfg, axes)))
