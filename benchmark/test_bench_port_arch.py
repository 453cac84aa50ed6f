"""The architecture interface (``archs/<arch>/``, ``harness/arch.py``).

- The dense family, ``archs/gpt``, against values frozen from the harness
  as it was before the family moved behind the interface, bit for bit: the
  leaves and their shapes, parameter counts, model FLOPs a token, the
  attention kernels' bounds at each cell's shapes, the cells' token pools,
  blocks 0 and 1 drawn from one seed, and the reference's losses and leaf
  norms at a tiny size.
- An architecture outside the dense family brought by new files only: a
  copy of the benchmark with ``testdata/toy_moe`` laid into it (the port's
  GPT with routed experts, and a reference whose Switch loss counts its
  shares over the whole batch), a whole run of its cell on the CPU
  passing its limits, the half-batch fault and the fp8 control failing
  them, and no file of the copy changed."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from archs.gpt.spec import ModelSpec
from harness import arch
from harness.cell import BENCH_DIR, load_cell
from harness.reference import AdamWConfig, run_reference
from harness.spec import ATTN_KERNELS, attn_bound_s
from harness.weights import block_weights, token_pool

ROOT = BENCH_DIR.parent
SEED = 2147483713
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4)


def config(name):
    if name == "tiny":
        return TINY
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


# name: (sha-256 of json.dumps(blocks()), leaves, parameters, {seq: model
# FLOPs a token}, sha-256 of blocks 0 and 1 drawn from SEED on the CPU)
FROZEN = {
    "stablelm-3b-4e1t": (
        "dd6745f118cdda4a00bb27d0d640989801e498fcdfa3cf6c72c877aa73c84d6f",
        291, 2_795_276_800, {4096: 18011258880.0, 1024: 16501309440.0},
        ("eda00cad600550f8c1eb0ac98daff13e9bc536cf63395f540ee57096cc388adb",
         "3fafe28e6639901e0cbb01866cb440d5835666b84b55acac4a00c31699d43a3d")),
    "olmo-7b": (
        "2bb62c2e5e76bd6f1fd31f4e1711735106465168bd4d79759bd44a56a9bceca6",
        291, 6_888_361_984, {2048: 41702916096.0},
        ("5b6c40ebe3b31e48baf57f9a73feb42ee06f6ec243013a38faa934ac06bfdf2a",
         "f445e24f9d4c35e92626c1c168640afc2bb2a2706c74ddc862db1310ea4d86d4")),
    "tiny": (
        "403752be6563d0077b78e42151842cbfadd373dfcf8b946526b40b95ca73b14c",
        21, 115_008, {32: 614400.0},
        ("4a8f5d53cc62d68670f236eae73f14db1269711705215bafd89b69057e348c27",
         "5e7d29a568e08d9e8f6e1ef86fb5c669b432bbbe9aa26f3f0402e2652a60395d")),
}

# cell: (B·H, S, head dim, {kernel: attn_bound_s}, sha-256 of the pool)
CELLS = {
    "stablelm3b.s4096": (128, 4096, 80, {
        "flash_fwd": (0.0003475038116885743, "operations"),
        "flash_bwd_dq": (0.0005212557175328615, "operations"),
        "flash_bwd_dkv": (0.0006950076233771486, "operations")},
        "8659f84280b6b3bf3e5b4434696e0b146c6a2322b8c4565812e35af0d924db03"),
    "stablelm3b.s1024": (256, 1024, 80, {
        "flash_fwd": (5.0394249552238804e-05, "bytes"),
        "flash_bwd_dq": (6.5204675429727e-05, "operations"),
        "flash_bwd_dkv": (8.6939567239636e-05, "operations")},
        "608b690a1e9d2b79556e1db3e00025604b47090415ca89483cc99a86bf2e0e96"),
    "olmo7b.fsdp4.s2048": (128, 2048, 128, {
        "flash_fwd": (0.00013903545231142567, "operations"),
        "flash_bwd_dq": (0.00020855317846713852, "operations"),
        "flash_bwd_dkv": (0.00027807090462285134, "operations")},
        "e6814899924836e83c492bf8bbb700fedaf8f5a8ca339b7ff6c16dc8f0f19ca9"),
}
TINY_BOUNDS = {"flash_fwd": (1.0087164179104477e-08, "bytes"),
               "flash_bwd_dq": (1.283820895522388e-08, "bytes"),
               "flash_bwd_dkv": (1.528358208955224e-08, "bytes")}

# The reference at TINY, two steps on token_pool(SEED, 4, 2, 32, 256),
# one thread: its losses, and the sha-256 of json.dumps([losses, sorted
# gradient norms, sorted change norms]).
TINY_POOL = "656b198160ff326edfaacbf617389a897f7bdc025ea635a7b14b8a04493dfd94"
TINY_LOSSES = [6.238210916519165, 6.111999750137329]
TINY_READINGS = \
    "a1a7e852d17ca53bfe8306eaa85f39fd18709e2c92e5c12eaa1bd2edc09652c0"


def _sha(data) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_the_dense_family_keeps_its_leaves_and_counts(name):
    spec = arch.spec(config(name))
    assert type(spec) is ModelSpec
    blocks, n_leaves, n_params, flops, _ = FROZEN[name]
    assert _sha(json.dumps(spec.blocks()).encode()) == blocks
    assert sum(len(b) for b in spec.blocks()) == n_leaves
    assert spec.n_params() == n_params
    for seq, f in flops.items():
        assert spec.model_flops_per_token(seq) == f


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_each_cell_keeps_its_attention_bounds_and_pool(workload):
    cell = load_cell(ROOT, workload)
    t = cell.traffic
    bh, seq, d, bounds, pool = CELLS[workload]
    assert cell.spec.attn_shapes(t) == [(1, bh, seq, d, d)]
    for k in ATTN_KERNELS:
        assert attn_bound_s(k, bh, seq, d, t["dtype"]) == bounds[k]
        assert attn_bound_s(k, bh, seq, d, t["dtype"], d_v=d) == bounds[k]
    got = token_pool(SEED, t["pool"], t["batch_per_rank"] * t["chips"],
                     t["seq"], cell.spec.vocab)
    assert _sha(got.tobytes()) == pool


def test_the_tiny_attention_bounds():
    spec = arch.spec(TINY)
    assert spec.attn_shapes({"batch_per_rank": 2, "seq": 32}) == [
        (1, 8, 32, 16, 16)]
    for k in ATTN_KERNELS:
        assert attn_bound_s(k, 8, 32, 16, "bfloat16") == TINY_BOUNDS[k]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_a_value_width_equal_to_the_head_width_changes_nothing(dtype):
    for bh, s, d in [(96, 1024, 64), (128, 4096, 80), (32, 1024, 256),
                     (7, 33, 16)]:
        for k in ATTN_KERNELS:
            assert attn_bound_s(k, bh, s, d, dtype, d_v=d) == \
                attn_bound_s(k, bh, s, d, dtype)


def test_a_value_width_of_its_own():
    """Latent attention's widths (q and k 192, v 128), counted by hand:
    K1 reads q, k, v and writes o and a row statistic, two products; K2
    reads q, k, v, dO and two row statistics and writes dQ, three
    products; K3 reads the same and writes dK and dV, four products."""
    bh, s, d, dv, el = 64, 8192, 192, 128, 2
    pairs, row = bh * s * (s + 1) // 2, 4 * bh * s
    want = {"flash_fwd": (el * bh * s * (2 * d + 2 * dv) + row,
                          2 * pairs * d + 2 * pairs * dv),
            "flash_bwd_dq": (el * bh * s * (3 * d + 2 * dv) + 2 * row,
                             2 * pairs * (d + dv) + 2 * pairs * d),
            "flash_bwd_dkv": (el * bh * s * (3 * d + 3 * dv) + 2 * row,
                              2 * pairs * (d + dv) + 2 * pairs * (d + dv))}
    for k, (nbytes, flops) in want.items():
        t, by = attn_bound_s(k, bh, s, d, "bfloat16", d_v=dv)
        assert t == max(nbytes / 3.35e12, flops / 989e12)
        assert by == "operations"


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_the_drawn_blocks_are_the_same_bits(name):
    spec = arch.spec(config(name))
    for block, want in enumerate(FROZEN[name][4]):
        h = hashlib.sha256()
        for leaf, w in block_weights(spec, SEED, block, "cpu").items():
            h.update(leaf.encode())
            h.update(memoryview(w.contiguous().numpy()).cast("B"))
        del w
        assert h.hexdigest() == want, (name, block)


def test_the_reference_reads_the_same_bits_at_a_tiny_size():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pool = token_pool(SEED, 4, 2, 32, 256)
        assert _sha(pool.tobytes()) == TINY_POOL
        r = run_reference(arch.spec(TINY), SEED,
                          [torch.from_numpy(pool[i]) for i in range(2)],
                          AdamWConfig(3e-4), "cpu")
    finally:
        torch.set_num_threads(threads)
    assert r.losses == TINY_LOSSES
    got = json.dumps([r.losses, sorted(r.grad_norms.items()),
                      sorted(r.change_norms.items())])
    assert _sha(got.encode()) == TINY_READINGS, got


# ---- an architecture brought by new files only ---------------------------

TOY = BENCH_DIR / "testdata" / "toy_moe"
TOY_CELL = "toy_moe.b4.s32"
TOY_RUN = r"""
import json, sys, time
from pathlib import Path
root = Path.cwd()
sys.path[:0] = [str(root / "benchmark"), str(root)]
import torch
torch.set_num_threads(2)
import calibrate
from harness.cell import load_cell
from harness.check import compare, judge
from harness.reference import AdamWConfig, run_reference
from harness.session import run_cell
from harness.weights import token_pool
seed = int(sys.argv[1])
cell = load_cell(root, sys.argv[2])
sound = run_cell(cell, seed, 0.3, True, time.time(), device="cpu")
half = run_cell(cell, seed + 1, 0.3, False, time.time(), device="cpu",
                fault=calibrate.FAULTS["half_batch"])
t = cell.traffic
pool = token_pool(seed, t["pool"], t["batch_per_rank"], t["seq"],
                  cell.spec.vocab)
batches = [torch.from_numpy(pool[i]) for i in range(cell.reference_steps)]
ref = run_reference(cell.spec, seed, batches, AdamWConfig(t["lr"]), "cpu")
ctl = run_reference(cell.spec, seed, batches, AdamWConfig(t["lr"]), "cpu",
                    "fp8")
control = judge(dict(compare(ctl, ref), nonfinite=0.0), cell.limits)
print(json.dumps({
    "leaves": sorted(n for b in cell.spec.blocks() for n, _ in b),
    "archs": sorted(m for m in sys.modules if m.startswith("archs.")),
    "sound": [sound["correct"], sound["checks"], sorted(sound["metrics"])],
    "half_batch": [half["correct"], half["checks"]],
    "control": [control["correct"], control["checks"]]}))
"""


def _hashes(top: Path) -> dict:
    return {str(p.relative_to(top)): _sha(p.read_bytes())
            for p in sorted(top.rglob("*")) if p.is_file()}


def test_an_architecture_added_by_new_files_only(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", copy)
    shutil.copytree(BENCH_DIR, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "ray_tpu_torch").symlink_to(ROOT / "ray_tpu_torch")
    before = _hashes(copy / "benchmark")
    bench = json.loads((copy / "BENCHMARK.json").read_text())

    added = []
    for p in sorted(TOY.rglob("*")):
        if not p.is_file() or "__pycache__" in p.parts \
                or p.name == "benchmark_entries.json":
            continue
        dst = copy / "benchmark" / p.relative_to(TOY)
        assert not dst.exists(), f"{dst} is not a new file"
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(p, dst)
        added.append(str(dst.relative_to(copy / "benchmark")))
    assert {"archs/toy_moe/spec.py", "archs/toy_moe/reference.py",
            "archs/toy_moe/program.py", "configs/toy-moe.json",
            f"limits/{TOY_CELL}.json"} <= set(added)
    entries = json.loads((TOY / "benchmark_entries.json").read_text())
    grown = dict(bench, **{k: bench[k] + v for k, v in entries.items()})
    (copy / "BENCHMARK.json").write_text(json.dumps(grown, indent=2))

    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1", USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", TOY_RUN, str(SEED),
                          TOY_CELL], cwd=copy, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])

    assert "layers.1.moe.router" in res["leaves"]
    assert {"archs.toy_moe.spec", "archs.toy_moe.reference",
            "archs.toy_moe.program"} <= set(res["archs"])
    correct, checks, metrics = res["sound"]
    assert correct, checks
    assert {"mfu_pct", "host_step_ms"} <= set(metrics)
    assert not res["half_batch"][0], res["half_batch"][1]
    assert not res["control"][0], res["control"][1]

    after = _hashes(copy / "benchmark")
    assert {k: after[k] for k in before} == before
    assert set(after) == set(before) | set(added)
    assert {k: v[:len(bench[k])] if isinstance(v, list) else v
            for k, v in grown.items()} == bench
