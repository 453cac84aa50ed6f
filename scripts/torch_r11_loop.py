"""Loop the port's oversize-output test under a load of other test processes.

    python scripts/torch_r11_loop.py [--runs 30] [--load 6] [--root DIR]
        [--test tests/test_torch_stage_pipeline.py::test_oversize_outputs_arrive_intact]

``StagePipeline.run`` over ``ray_tpu`` receives outputs above a channel slot
as views of object-store memory (ROADMAP R-11). The test that holds them
intact passes alone and failed once in a loaded tier-1 run. This script
reruns it ``--runs`` times in a row, one pytest process each, while
``--load`` xdist workers run the rest of ``tests/test_torch_*.py`` beside
it (restarted whenever they finish), and prints the pass and fail counts.
``--root`` runs it in another checkout (a parent commit unpacked with
``git archive``). It runs on the CPU; JAX_PLATFORMS=cpu is set for the
tests that import JAX.
"""

from __future__ import annotations

import argparse
import glob
import os
import signal
import subprocess
import sys
import time

TEST = ("tests/test_torch_stage_pipeline.py::"
        "test_oversize_outputs_arrive_intact")


def _load(root: str, workers: int, test_file: str) -> subprocess.Popen:
    files = sorted(f for f in glob.glob(os.path.join(root, "tests",
                                                     "test_torch_*.py"))
                   if os.path.basename(f) != os.path.basename(test_file))
    cmd = [sys.executable, "-m", "pytest", "-q", "-x", "-p", "no:cacheprovider",
           "-p", "xdist", "-n", str(workers), "--dist", "loadfile",
           "-m", "not slow and not cuda", *files]
    return subprocess.Popen(cmd, cwd=root, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, start_new_session=True)


def _stop(p: subprocess.Popen) -> None:
    if p.poll() is None:
        os.killpg(p.pid, signal.SIGTERM)
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--load", type=int, default=6,
                    help="xdist workers of the other tests (0: no load)")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--test", default=TEST)
    args = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    root = os.path.abspath(args.root)
    load = _load(root, args.load, args.test.split("::")[0]) \
        if args.load else None
    passed = failed = 0
    t0 = time.time()
    try:
        for i in range(args.runs):
            if load is not None and load.poll() is not None:
                load = _load(root, args.load, args.test.split("::")[0])
            r = subprocess.run(
                [sys.executable, "-m", "pytest", "-q", "-p",
                 "no:cacheprovider", "-p", "no:xdist", args.test],
                cwd=root, capture_output=True, text=True)
            ok = r.returncode == 0
            passed += ok
            failed += not ok
            tail = "" if ok else " | " + " ".join(
                line.strip() for line in r.stdout.splitlines()
                if "assert" in line or "Error" in line)[:300]
            print(f"run {i + 1}: {'pass' if ok else 'FAIL'} "
                  f"({time.time() - t0:.0f} s){tail}", flush=True)
    finally:
        if load is not None:
            _stop(load)
    print(f"{args.test} under {args.load} loading workers in {root}: "
          f"{passed} passed, {failed} failed of {args.runs}", flush=True)
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
