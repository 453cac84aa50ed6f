"""A gang of the port's train workers over ray_tpu actors on the CPU: two
worker processes, one device each, joined by CudaBackendConfig(
distributed="force", platform="cpu") into a gloo group, run the port's
mp_check workload (fsdp over the two processes) through Trainer.fit() and
report its loss, their pids and ranks. The bounds are those of
tests/test_torch_mp_check.py for its subprocess gang: in fp32 within 1e-5
of the same loss in one process; in bf16 from JAX's weights within 1e-3
relative of JAX's ray_tpu.parallel.mp_check.step_loss.

Last, a gang restart across the two workers: rank 1 raises before step 2,
the gang restarts from the sharded save_pytree checkpoint after step 1, and
the final loss and TrainState equal an uninterrupted gang's bit for bit
(chip_smoke.harness_loop, the loop of chip_smoke.py's phase (p), at a tiny
width on the CPU).
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.models import convert
from ray_tpu_torch.parallel import mp_check

GLOO = ttrain.CudaBackendConfig(distributed="force", platform="cpu")


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu
    ray_tpu.init(num_cpus=4, num_tpus=0)
    yield ray_tpu
    ray_tpu.shutdown()


@pytest.fixture(scope="module")
def jax_weights(jax_cpu):
    from ray_tpu.models.gpt import GPTConfig, gpt_init
    cfg = GPTConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                    d_ff=256, max_seq=64)
    return convert.flatten(jax_cpu.tree_util.tree_map(
        np.asarray, gpt_init(jax_cpu.random.PRNGKey(0), cfg)))


def _gang_losses(cluster, tmp_path, weights, dtype):
    """mp_check.step_loss(1, 2) on two gloo workers through Trainer.fit():
    -> (rank 0's reported loss, {rank: (loss, pid)})."""
    out = str(tmp_path)

    def loop(config):
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.parallel import mp_check as mc
        ctx = train.get_context()
        loss = mc.step_loss(1, 2, device="cpu", weights=config["weights"],
                            dtype=getattr(torch, config["dtype"]))
        rank = ctx.get_world_rank()
        assert dist.get_rank() == rank and dist.get_world_size() == 2
        with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as f:
            json.dump({"loss": loss, "pid": os.getpid(),
                       "env": os.environ["RANK"]}, f)
        train.report({"loss": loss, "rank": rank})

    r = ttrain.Trainer(loop, train_loop_config={
        "weights": weights, "dtype": dtype, "out": out},
        scaling_config=ttrain.ScalingConfig(num_workers=2),
        backend_config=GLOO, runtime=cluster).fit()
    ranks = {}
    for rank in range(2):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            ranks[rank] = json.load(f)
    assert [ranks[r]["env"] for r in range(2)] == ["0", "1"]
    assert ranks[0]["pid"] != ranks[1]["pid"] != os.getpid()
    assert r.metrics["rank"] == 0
    return r.metrics["loss"], [ranks[r]["loss"] for r in range(2)]


@pytest.mark.timeout(240)
def test_gang_fp32_matches_one_process(cluster, jax_weights, tmp_path):
    reported, losses = _gang_losses(cluster, tmp_path, jax_weights,
                                    "float32")
    baseline = mp_check.step_loss(1, 1, device="cpu", weights=jax_weights,
                                  dtype=torch.float32)
    assert losses[0] == losses[1] == reported
    assert abs(reported - baseline) < 1e-5, (reported, baseline)


@pytest.mark.timeout(240)
def test_gang_bf16_matches_jax_step_loss(cluster, jax_weights, tmp_path):
    from ray_tpu.parallel import mp_check as jax_mp_check
    reported, losses = _gang_losses(cluster, tmp_path, jax_weights,
                                    "bfloat16")
    ref = jax_mp_check.step_loss(1, 2)
    assert losses[0] == losses[1] == reported
    assert abs(reported - ref) <= 1e-3 * abs(ref), (reported, ref)


# chip_smoke.harness_loop at a tiny width, fsdp over the two workers.
TINY = dict(device="cpu", batch=4, seq=32, steps=4, every=2, fail_at=2,
            fail_rank=1, mesh={"fsdp": 2}, strategy="fsdp",
            cfg=dict(vocab_size=256, d_model=64, n_layers=2, n_heads=2,
                     d_ff=128, max_seq=32, dtype=torch.float32))


@pytest.mark.timeout(300)
def test_gang_restart_resumes_bit_for_bit(cluster, tmp_path):
    root = str(tmp_path)
    gang = dict(workers=2, runtime=cluster, backend=GLOO)
    ref, ref_dir = chip_smoke.harness_fit(root, "B", **gang,
                                          **dict(TINY, fail_at=None))
    run, run_dir = chip_smoke.harness_fit(root, "A", failures=1, **gang,
                                          **TINY)
    ok, reading, _ = chip_smoke.harness_gate(run_dir, ref_dir)
    assert ok, reading
    events = [chip_smoke.harness_events(run_dir, r) for r in range(2)]
    # Rank 1 raised before step 2; both ranks restarted from the checkpoint
    # after step 1, in new processes.
    assert [e["step"] for e in events[1] if e["event"] == "raise"] == [2]
    for ev in events:
        starts = [e for e in ev if e["event"] == "start"]
        assert len(starts) == 2 and starts[0]["pid"] != starts[1]["pid"]
        assert [e["step"] for e in ev if e["event"] == "load"] == [2]
        assert [(e["attempt"], e["step"]) for e in ev
                if e["event"] == "step"][-2:] == [(2, 2), (2, 3)]
    assert run.error is None and run.metrics["step"] == 3
    assert [m["step"] for _, m in run.best_checkpoints] == [1, 3]
