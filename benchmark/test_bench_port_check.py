"""The check that decides ``correct``, driven through a whole run of each
cell's harness on the CPU at a small size, with the cell's own limits: a
sound run passes, and the run comes out not correct with the timed path
broken underneath (a step that leaves its state unchanged; half of each
batch left out, the mean over the rest; on several cards, the exchange of
gradients between them left out) and with the fp8 control in the
program's place. A cell of several cards runs as many gloo ranks."""

import dataclasses
import json
import socket
import time
from pathlib import Path

import pytest
import torch

import calibrate
from harness import arch
from harness.cell import load_cell
from harness.check import compare, judge
from harness.reference import AdamWConfig, run_reference
from harness.session import result_line, run_cell
from harness.weights import token_pool

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4)
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def small(workload):
    """The cell with its traffic's kind and its limits, at a size the CPU
    holds: a two-layer model of the cell's family, 2 x 32 tokens a rank,
    in float32 (bf16's rounding at this size is not the cell's: the limits
    were set from the cell's own size on the card)."""
    cell = load_cell(ROOT, workload)
    config = dict(cell.config, **SMALL)
    traffic = dict(cell.traffic, batch_per_rank=2, seq=32, dtype="float32")
    return dataclasses.replace(cell, config=config, traffic=traffic,
                               spec=arch.spec(config))


def _rank(rank, port, workload, seed, fault, trace, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    cell = small(workload)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=cell.chips, rank=rank)
    res = run_cell(cell, seed, 0.3, trace, time.time(), device="cpu",
                   fault=calibrate.FAULTS.get(fault))
    dist.destroy_process_group()
    if rank == 0:
        Path(out).write_text(json.dumps(res))


def run(workload, seed, fault=None, trace=False, tmp_path=None):
    cell = small(workload)
    if cell.chips == 1:
        return run_cell(cell, seed, 0.3, trace, time.time(), device="cpu",
                        fault=calibrate.FAULTS.get(fault))
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "rank0.json"
    mp.spawn(_rank, args=(port, workload, seed, fault, trace, str(out)),
             nprocs=cell.chips)
    return json.loads(out.read_text())


def faults(workload):
    several = load_cell(ROOT, workload).chips > 1
    return ["state_unchanged", "half_batch"] + (
        ["no_exchange"] if several else [])


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, tmp_path):
    out = run(workload, SEEDS[0], trace=True, tmp_path=tmp_path)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    line = result_line(out, {"platform": "cpu"})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert "breakdown" in line


@pytest.mark.parametrize("workload, fault", [
    (w, f) for w in CELLS for f in faults(w)])
def test_a_broken_step_is_not_correct(workload, fault, tmp_path):
    out = run(workload, SEEDS[1], fault, tmp_path=tmp_path)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_the_fp8_control_is_not_correct(workload, seed):
    cell = small(workload)
    t = cell.traffic
    pool = token_pool(seed, t["pool"], t["batch_per_rank"] * cell.chips,
                      t["seq"], cell.spec.vocab)
    batches = [torch.from_numpy(pool[i]) for i in range(3)]
    opt = AdamWConfig(t["lr"])
    ref = run_reference(cell.spec, seed, batches, opt, "cpu")
    ctl = run_reference(cell.spec, seed, batches, opt, "cpu", "fp8")
    numbers = dict(compare(ctl, ref), nonfinite=0.0)
    assert not judge(numbers, cell.limits)["correct"], numbers
