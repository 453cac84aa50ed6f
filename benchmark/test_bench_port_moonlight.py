"""The DeepSeek-V3 architecture (``archs/moonlight``) and its cell
``moonlight16b.e8.s8192``: the spec's counts, model FLOPs and attention
shapes against figures worked out by hand; a whole run on the CPU at a
small size with Moonlight's shape ratios, in which the sound step passes
the cell's limits, the half-batch fault, a fault planted in the expert
layer (the routed scale left out) and the fp8 control fail them, and the
expert layer's metrics read what the port's spans and counters give;
``moe_roofline`` on made-up readings."""

import dataclasses
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import calibrate
from harness import arch
from harness.cell import load_cell, reader
from harness.check import compare, judge
from harness.reference import AdamWConfig, run_reference
from harness.session import run_cell
from harness.weights import token_pool
from test_bench_port_files import ARCH_FILES

ROOT = Path(__file__).resolve().parents[1]
CELL = "moonlight16b.e8.s8192"
SEED = 2 ** 31 + 2027
# Moonlight's shape ratios at a size the CPU holds: 4 heads of q and k 24
# (16 + 8 rotated) and v 16, a latent of 32, 16 experts routed over of
# which 4 held, top 4, 2 shared, one dense layer and two expert layers.
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             moe_intermediate_size=32, n_routed_experts=4,
             num_experts_per_tok=4,
             published={"n_routed_experts": 16, "vocab_size": 256})


def test_the_spec_counts_by_hand():
    """d 2048, V 20480, 16 heads, 27 layers (1 dense of 11264), 8 held of
    64 experts of 1408, top 6, 2 shared."""
    spec = load_cell(ROOT, CELL).spec
    d, v = 2048, 20480
    attn = d * 16 * 192 + d * (512 + 64) + 512 + 512 * 16 * 256 \
        + 16 * 128 * d + 2 * d                      # with ln1, ln2
    dense = attn + 3 * d * 11264
    experts = 8 * 3 * d * 1408
    moe = attn + d * 64 + experts + 3 * d * 2816
    assert spec.n_params() == 2 * v * d + d + dense + 26 * moe \
        == 2_777_411_072
    assert sum(len(b) for b in spec.blocks()) == 3 + 10 + 26 * 14
    products = v * d + 27 * (attn - 512 - 2 * d) + 3 * d * 11264 + 26 * (
        d * 64 + 3 * d * 2816 + experts * 6 / 64)
    attention = 3 * 27 * 8192 * 16 * (192 + 128)
    assert spec.model_flops_per_token(8192) == 6 * products + attention \
        == 10_025_435_136
    assert attention / spec.model_flops_per_token(8192) == pytest.approx(
        0.339, abs=5e-4)
    assert spec.attn_shapes(load_cell(ROOT, CELL).traffic) == [
        (1, 64, 8192, 192, 128)]


def test_the_architecture_is_under_the_import_tests():
    assert {p.stem for p in ARCH_FILES if p.parent.name == "moonlight"} == {
        "spec", "reference"}


def small():
    cell = load_cell(ROOT, CELL)
    config = dict(cell.config, **SMALL)
    traffic = dict(cell.traffic, batch_per_rank=2, seq=32, dtype="float32")
    return dataclasses.replace(cell, config=config, traffic=traffic,
                               spec=arch.spec(config))


def no_routed_scale(prog) -> None:
    """Fault: the expert layer leaves out the routed scale (2.446)."""
    model = prog.model
    for m in [model, *model.layers]:
        m.cfg = dataclasses.replace(m.cfg, routed_scale=1.0)


@pytest.fixture(scope="module")
def sound():
    from ray_tpu_torch.models.gpt import EXPERTS
    before = dataclasses.replace(EXPERTS)
    out = run_cell(small(), SEED, 0.3, True, time.time(), device="cpu")
    return out, before, dataclasses.replace(EXPERTS)


def test_a_sound_run_is_correct_and_reads_the_expert_layer(sound):
    out, before, after = sound
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert {"mla_ms", "moe_ms", "moe_roofline", "mfu_pct"} <= set(got), got
    assert got["mla_ms"] > 0 and got["moe_ms"] > 0 and got["moe_roofline"] > 0
    # Two expert layers, forward and recompute, each step: routed rows
    # about k x held / e = 1 a token.
    assert (after.calls - before.calls) % 4 == 0
    rows = (after.rows - before.rows) / (after.calls - before.calls)
    assert 0.5 * 64 < rows < 1.5 * 64


@pytest.mark.parametrize("fault", [calibrate.half_batch, no_routed_scale],
                         ids=["half_batch", "no_routed_scale"])
def test_a_broken_step_is_not_correct(fault):
    out = run_cell(small(), SEED + 1, 0.3, False, time.time(), device="cpu",
                   fault=fault)
    assert not out["correct"], out["checks"]


def test_the_fp8_control_is_not_correct():
    cell = small()
    t = cell.traffic
    pool = token_pool(SEED, t["pool"], t["batch_per_rank"], t["seq"],
                      cell.spec.vocab)
    batches = [torch.from_numpy(pool[i]) for i in range(2)]
    opt = AdamWConfig(t["lr"])
    ref = run_reference(cell.spec, SEED, batches, opt, "cpu")
    ctl = run_reference(cell.spec, SEED, batches, opt, "cpu", "fp8")
    numbers = dict(compare(ctl, ref), nonfinite=0.0)
    assert not judge(numbers, cell.limits)["correct"], numbers


def test_the_reference_moves_the_bias_as_the_program_does():
    """After each of two steps from the seed, every expert layer's
    selection bias in the program (the port's ``GPT.step_done``) is the
    reference's for the next step, and it has moved from zeros."""
    from harness.program import Program
    from harness.reference import Reference
    from archs.moonlight import reference as moon
    cell = small()
    t, spec = cell.traffic, cell.spec
    assert spec.bias_rate == 0.001
    pool = token_pool(SEED, t["pool"], t["batch_per_rank"], t["seq"],
                      spec.vocab)
    prog = Program(spec, t, pool, SEED, "cpu")
    ref = Reference(spec, SEED, AdamWConfig(t["lr"]), "cpu")
    moes = [i for i in range(spec.n_layers) if i >= spec.first_dense]
    for step in range(2):
        prog.run_step()
        ref.step(torch.from_numpy(pool[step]))
        for i in moes:
            router = ref.params[f"layers.{i}.moe.router"]
            want = moon._BY_STORAGE[router.data_ptr()]["next"]
            got = prog.model.layers[i].moe.bias
            assert torch.equal(got, want), (step, i)
            assert got.abs().sum() > 0


class _Span:
    def __init__(self, name, ns):
        self.name, self.ns = name, ns

    def device_ns(self):
        return self.ns


def test_moe_roofline_by_hand(monkeypatch):
    """Two passes of 10 ms over 4 x 8192 tokens, 49,152 routed rows: the
    forward products over 989 TFLOP/s against 20 ms; nothing where the
    counters and the spans disagree, or without a profile."""
    import harness.port_spans as ps
    monkeypatch.setattr(ps, "stretch", lambda run: [
        _Span("experts", 10 ** 7), _Span("experts", 10 ** 7),
        _Span("mla", 10 ** 7)])
    cell = load_cell(ROOT, CELL)
    profile = SimpleNamespace(launches={"experts.calls": 2,
                                        "experts.rows": 49152})
    run = SimpleNamespace(profile=profile, spec=cell.spec,
                          traffic=cell.traffic)
    read = reader("moe_roofline")
    flops = 2 * 3 * 2048 * (1408 * 49152 + 2816 * 2 * 4 * 8192)
    assert read(run) == pytest.approx(100 * flops / 989e12 / 0.02,
                                      rel=1e-12)
    profile.launches["experts.calls"] = 3
    assert read(run) is None
    assert read(SimpleNamespace(profile=None)) is None


def test_the_cell_is_one_card_and_names_its_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert cell["chips"] == 1
    mine = [m["name"] for m in bench["per_layer"]
            if m.get("workloads") == [CELL]]
    assert mine == ["mla_ms", "moe_ms", "moe_roofline"]
