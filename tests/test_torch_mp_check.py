"""The port's multi-process gang check (ray_tpu_torch/parallel/mp_check.py)
against its one-process loss and against JAX's ray_tpu.parallel.mp_check.

The fixed workload of both modules (vocab 512, d 128, 2 layers, 4 heads,
d_ff 256, seq 64, batch 8, 2 AdamW(1e-3) steps of "fsdp", tokens from
seed 7) starts from JAX's gpt_init(PRNGKey(0)) weights. A gang of 2 gloo
processes, one device each, over data x fsdp, is held to the loss of the
whole batch in one process within 1e-5, as JAX holds its gang, in fp32:
each rank rounds the weight gradients of its own rows, so in bf16 the
gang and one process differ by that rounding (5.4e-5 relative here; JAX's
own bf16 losses on a 2x4 and a 1x1 mesh differ by 2.9e-5). In bf16, the
workload's own dtype, the gang is held to JAX's step_loss on the same mesh
within 1e-3 relative, a quarter of one bf16 unit in the last place (XLA
and torch round bf16 products at other points; measured 1.3e-4).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.parallel import mp_check


@pytest.fixture(scope="module")
def jax_weights(jax_cpu, tmp_path_factory):
    from ray_tpu.models.gpt import GPTConfig, gpt_init
    cfg = GPTConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                    d_ff=256, max_seq=64)
    tree = convert.flatten(jax_cpu.tree_util.tree_map(
        np.asarray, gpt_init(jax_cpu.random.PRNGKey(0), cfg)))
    path = tmp_path_factory.mktemp("mp_check") / "weights.npz"
    np.savez(path, **tree)
    return tree, str(path)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("data,fsdp", [(1, 2), (2, 1)])
def test_gang_matches_one_process(jax_weights, data, fsdp):
    tree, path = jax_weights
    baseline = mp_check.step_loss(1, 1, device="cpu", weights=tree,
                                  dtype=torch.float32)
    gang = mp_check.run_gang_subprocesses(2, 1, data, fsdp, platform="cpu",
                                          dtype="float32", weights_path=path)
    assert len(gang) == 2 and gang[0] == gang[1]
    assert all(abs(x - baseline) < 1e-5 for x in gang), (gang, baseline)


@pytest.mark.timeout(300)
def test_gang_matches_jax_step_loss(jax_weights):
    from ray_tpu.parallel import mp_check as jax_mp_check
    _, path = jax_weights
    gang = mp_check.run_gang_subprocesses(2, 1, 1, 2, platform="cpu",
                                          weights_path=path)
    ref = jax_mp_check.step_loss(1, 2)
    assert all(abs(x - ref) <= 1e-3 * abs(ref) for x in gang), (gang, ref)


def test_gang_runs_on_the_cards_by_default():
    """Without platform="cpu" the gang is NCCL on the cards: with no card
    it raises before it starts a process."""
    if torch.cuda.is_available():
        pytest.skip("a card is present (tests/test_torch_cuda.py runs the "
                    "gang on the cards)")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mp_check.run_gang_subprocesses(2, 1, 1, 2)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        mp_check.run_gang_subprocesses(2, 1, 1, 2, platform="tpu")


def test_several_devices_per_process_raise():
    """A torch process owns one device: JAX's local_devices > 1 raises."""
    with pytest.raises(ValueError, match="one device"):
        mp_check.run_gang_subprocesses(2, 4, 2, 4)
    with pytest.raises(ValueError, match="one device"):
        mp_check.init_process(0, 2, "127.0.0.1:1", 2)
