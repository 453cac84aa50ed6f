"""Time K1-K3 at the main shape on the card for two trees, alternating.

    python scripts/torch_kernel_ab.py --parent DIR [--out build/kernel_ab.log]

``DIR`` holds another checkout's ``ray_tpu_torch/`` and ``chip_smoke.py``
(for example a parent commit unpacked with ``git archive`` into a
git-ignored directory). Each side builds its own kernels, then
``chip_smoke.phase_timing()`` runs in a process of its own, in the order
parent, change, change, parent, so that both are compared within one
machine and call. Prints each run's build time and phase (f) lines; the
full output goes to ``--out``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

CODE = ("import sys, time; sys.path.insert(0, '.'); import chip_smoke as c; "
        "c.phase_device(); t = time.perf_counter(); c.phase_build(); "
        "print('build', round(time.perf_counter() - t, 1), 's', flush=True);"
        " r = c.phase_timing(); "
        "print('RESULT', {k: v['ms'] for k, v in r.items()}, flush=True)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default="build/kernel_ab.log")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": os.path.abspath(args.parent), "change": root}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    failed = False
    with open(args.out, "w") as log:
        for name in ("parent", "change", "change", "parent"):
            t0 = time.time()
            p = subprocess.run([sys.executable, "-c", CODE], cwd=trees[name],
                               capture_output=True, text=True)
            log.write(f"=== {name} rc={p.returncode} "
                      f"{time.time() - t0:.1f}s\n{p.stdout}\n{p.stderr}\n")
            log.flush()
            for line in p.stdout.splitlines():
                if line.startswith(("RESULT", "build", "NVIDIA", "[f]")):
                    print(name, line, flush=True)
            if p.returncode:
                print(name, "failed:", p.stderr[-2000:], flush=True)
                failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
