"""The collectives of a split model inside checkpointed layers.

Under remat "full" and "dots" the backward recomputes each layer, and
with it the collectives of the Megatron pair (parallel/tensor_parallel.py)
that the recompute reaches. They run in the same order on every rank, as
the forward's do.

- Two gloo ranks on tensor=2 count the all_reduce calls of one gpt_loss of
  GPTConfig.tiny() (2 dense layers): the forward runs 8 (per layer the
  outputs of attention and of the MLP, then the embedding, and the
  cross-entropy's max, sum of exponentials and target logit); the
  backward 8 with remat "none" (per layer the inputs' gradients of
  attention and of the MLP, the head's input, and the cross-entropy
  chunk's recompute) and 2 more under "full" and under "dots": each
  layer's recompute runs attention's all-reduce again. The backward runs
  outside the step's context, as under CUDA, whose autograd engine runs
  it (and the recompute) on a thread of its own: the layer carries the
  context into its recompute. "dots" saves only
  the outputs of aten.mm, so it recomputes the collectives rather than
  saving their outputs; the MLP's all-reduce, past the last tensor the
  backward needs, is never recomputed (the recompute stops early).
- "tp_fsdp" on data=2 x fsdp=2 x tensor=2 with MoE (4 experts) under remat
  "dots" and accum_steps=2, against JAX's step with the same policy on
  the 8-device CPU mesh, with tests/test_torch_strategies.py's bounds and
  checks, unequal masks in one microbatch's rows of one coordinate.
"""

import numpy as np
import pytest

from ray_tpu_torch.models import convert
from test_torch_strategies import (assert_matches, jax_run, jax_tree, launch,
                                   tokens, train_run)


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


@pytest.mark.timeout(300)
def test_remat_recomputes_the_collectives_in_order(tmp_path):
    ranks = launch(tmp_path, [dict(
        tag="", kind="count", mesh={"tensor": 2}, strategy="tp", cfg={},
        tokens="tokens", policies=["none", "full", "dots"])],
        {"tokens": tokens(2, slice(1, 2))}, world=2)
    for out in ranks:
        assert out["none"].tolist() == [8, 8]
        assert out["full"].tolist() == [8, 10]
        assert out["dots"].tolist() == [8, 10]


@pytest.mark.timeout(300)
def test_tp_fsdp_moe_under_dots_with_accum_matches_jax(jx, tmp_path):
    axes = dict(data=2, fsdp=2, tensor=2)
    cfg = dict(n_experts=4, remat_policy="dots")
    jcfg, tree = jax_tree(jx, **cfg)
    toks = np.stack([tokens(8, slice(2, 3), seed=5),
                     tokens(8, slice(0, 0), seed=6)])
    arrays = {"tokens": toks, **{f"param:{k}": v for k, v in
                                 convert.flatten(tree).items()}}
    ranks = launch(tmp_path, [train_run("", "tp_fsdp", axes, cfg, accum=2)],
                   arrays)
    assert_matches(ranks, "", *jax_run(jx, jcfg, tree, toks, "tp_fsdp", axes,
                                       accum=2))
