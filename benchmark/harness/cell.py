"""A cell of ``BENCHMARK.json`` resolved to its files, found by name: the
configuration's file (``configs``) and its architecture's spec
(``benchmark/archs/<arch>/``, ``harness/arch.py``), the traffic mix
(``benchmark/traffic/<traffic>.json``), its check's limits and the steps
the reference follows (``benchmark/limits/<workload>.json``) and a reader for each metric it
reports (``benchmark/metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

from harness import arch

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    spec: object           # the architecture's spec of ``config``
    traffic: dict
    limits: Dict[str, float]
    reference_steps: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" /
                          f"{w['traffic']}.json").read_text())
    check = json.loads((BENCH_DIR / "limits" / f"{workload}.json")
                       .read_text())
    if traffic["chips"] != w["chips"]:
        raise ValueError(f"{workload}: BENCHMARK.json asks for {w['chips']} "
                         f"chips, traffic {w['traffic']!r} for "
                         f"{traffic['chips']}")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(workload, w["chips"], config, arch.spec(config),
                traffic, check["limits"], check["reference_steps"], e2e,
                per_layer)


def reader(metric: str) -> Callable:
    """``read(run) -> number or None`` of ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
