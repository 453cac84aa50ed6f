"""BENCHMARK.json against the files it names, the imports of the
benchmark's modules, and what a run does where it must not measure."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from harness.cell import BENCH_DIR, load_cell, reader

ROOT = BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "ray_tpu"}


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    cell = load_cell(ROOT, workload)
    assert cell.traffic["chips"] == cell.chips
    assert {"grad", "change", "nonfinite"} <= set(cell.limits) <= {
        "loss", "loss1", "grad", "change", "nonfinite"}
    assert cell.reference_steps in (2, 3)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "tokens_per_s"}
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reader(m["name"]))


def _modules(path: Path) -> set:
    """Dotted names of the modules ``path`` imports (``from a import b``
    gives ``a`` and ``a.b``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out |= {node.module} | {f"{node.module}.{a.name}"
                                    for a in node.names}
    return out


def _imports(path: Path) -> set:
    """Top-level names of the modules ``path`` imports."""
    return {n.split(".")[0] for n in _modules(path)}


PY_FILES = sorted(str(p.relative_to(BENCH_DIR))
                  for p in BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", PY_FILES)
def test_no_module_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: ``ray_tpu_torch`` is not
    ``ray_tpu``."""
    assert not _imports(BENCH_DIR / path) & FORBIDDEN


# Every architecture's reference and spec: the benchmark's own, and those
# its tests bring (``testdata/<name>/archs/<arch>/``).
ARCH_FILES = sorted(p for p in BENCH_DIR.rglob("archs/*/*.py")
                    if p.stem in ("reference", "spec"))


def _own_file(base: Path, dotted: str):
    """The benchmark's file of the module ``dotted`` (under ``base``, then
    the benchmark's directory), or None for another package's."""
    for root in (base, BENCH_DIR):
        p = root.joinpath(*dotted.split("."))
        for f in (p.with_suffix(".py"), p / "__init__.py"):
            if f.is_file():
                return f
    return None


def test_reference_imports_nothing_of_the_program():
    """The reference's runner, every architecture's reference and spec,
    and the benchmark modules they import."""
    starts = [(BENCH_DIR, BENCH_DIR / "harness" / "reference.py")] + [
        (p.parents[2], p) for p in ARCH_FILES]
    seen, todo = set(), list(starts)
    while todo:
        base, path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        assert "ray_tpu_torch" not in _imports(path), path
        todo += [(base, f) for f in (_own_file(base, n)
                                     for n in _modules(path)) if f]
    rel = {str(p.relative_to(BENCH_DIR)) for p in seen}
    assert rel >= {"harness/reference.py", "harness/weights.py",
                   "harness/arch.py", "archs/gpt/reference.py",
                   "archs/gpt/spec.py"}


def test_every_architecture_is_under_the_import_tests():
    """Each architecture's reference and spec is among the files whose
    imports are checked for JAX, and its spec imports nothing but the
    standard library (and specs of other architectures)."""
    assert {p.parent.name for p in ARCH_FILES} >= {"gpt", "toy_moe"}
    for p in ARCH_FILES:
        assert str(p.relative_to(BENCH_DIR)) in PY_FILES
        if p.stem != "spec":
            continue
        for n in _modules(p):
            parts = n.split(".")
            assert (parts[0] in sys.stdlib_module_names | {"__future__"}
                    or parts[0] == "archs" and parts[2:3] == ["spec"]), (p, n)


def _run(cwd, *extra, env=None):
    workload = BENCH["workloads"][0]["name"]
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=env)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA is not available" in out.stderr


def test_a_run_beside_no_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
