"""Time K1-K3 at the main shape on the card for two trees, alternating.

    python scripts/torch_kernel_ab.py --parent DIR [--out build/kernel_ab.log]
        [--shape B,H,S,D[,DTYPE] ...]

``DIR`` holds another checkout's ``ray_tpu_torch/`` and ``chip_smoke.py``
(for example a parent commit unpacked with ``git archive`` into a
git-ignored directory). Each side builds its own kernels, then
``chip_smoke.phase_timing()`` runs in a process of its own at the main
shape and at each ``--shape`` (batch, heads, seq, head dim, and a torch
dtype name, bfloat16 if none; causal), in the order parent, change, change,
parent, ``--rounds`` times, so that both are compared within one machine
and call. Prints each run's build time, the card's SM clock and
temperature before it, and phase (f) lines; the full output goes to
``--out``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

# Trees before fp16 had a tensor-core route had no fp16 peak to bound it by.
CODE = ("import sys, time, torch; sys.path.insert(0, '.'); "
        "import chip_smoke as c; "
        "c.PEAK_FLOPS.setdefault(torch.float16, c.PEAK_FLOPS[torch.bfloat16]);"
        " "
        "c.phase_device(); t = time.perf_counter(); c.phase_build(); "
        "print('build', round(time.perf_counter() - t, 1), 's', flush=True);"
        " r = c.phase_timing(); "
        "print('RESULT', {{k: v['ms'] for k, v in r.items()}}, flush=True)\n"
        "for b, h, s, d, dt in {shapes}:\n"
        "    r = c.phase_timing(dict(batch=b, heads=h, seq=s, head_dim=d, "
        "dtype=getattr(torch, dt)), f'shape {{b}}x{{h}}x{{s}}x{{d}} {{dt}}')\n"
        "    print('RESULT', (b, h, s, d, dt), "
        "{{k: v['ms'] for k, v in r.items()}}, flush=True)")

SMI = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
       "--format=csv,noheader"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default="build/kernel_ab.log")
    ap.add_argument("--shape", action="append", default=[],
                    help="B,H,S,D[,DTYPE] of another causal shape to time")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    shapes = []
    for sh in args.shape:
        parts = sh.split(",")
        dtype = parts[4] if len(parts) > 4 else "bfloat16"
        shapes.append((*(int(x) for x in parts[:4]), dtype))
    code = CODE.format(shapes=shapes)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": os.path.abspath(args.parent), "change": root}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    failed = False
    with open(args.out, "w") as log:
        for name in ("parent", "change", "change", "parent") * args.rounds:
            smi = subprocess.run(SMI, capture_output=True, text=True)
            print(name, "before: sm MHz, W, C", smi.stdout.strip(),
                  flush=True)
            t0 = time.time()
            p = subprocess.run([sys.executable, "-c", code], cwd=trees[name],
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
