"""A whole run of the one-card cell on the card, from the one command:
correct, on the card it names. Skips where there is no card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from harness.cell import load_cell

ROOT = Path(__file__).resolve().parents[1]
CELL = "stablelm3b.s1024"


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 999), "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert set(line["metrics"]) == {
        m["name"] for m in load_cell(ROOT, CELL).end_to_end}
