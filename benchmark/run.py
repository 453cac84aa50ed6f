#!/usr/bin/env python3
"""The training benchmark of ``ray_tpu_torch`` on NVIDIA H100 cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. One run of one cell of ``BENCHMARK.json``:
set-up from the seed, a measured window of ``--seconds``, the check of the
first steps against the plain reference, and as the last line of standard
output one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``; ``breakdown`` with ``--trace 1``; the numbers
compared, each beside its limit, under ``checks``, last). With ``--trace
0`` the metrics are the cell's end-to-end ones, with ``--trace 1`` its
per-layer ones. Exits non-zero, printing no result, without enough cards,
without the port beside the benchmark, or where JAX or the JAX package
was loaded."""

import time

T0 = time.time()   # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``ray_tpu_torch`` is not ``ray_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_ranks(world: int, port: int) -> list:
    """Ranks 1..world-1 as processes of this script, their output on this
    one's standard error; a watchdog ends the run where one fails, since
    the others would wait in a collective for ever."""
    import threading
    children = [subprocess.Popen(
        [sys.executable, __file__, *sys.argv[1:], "--rank", str(r),
         "--port", str(port)], stdout=sys.stderr, stderr=sys.stderr)
        for r in range(1, world)]

    def watch():
        while any(c.poll() is None for c in children):
            if any(c.poll() not in (None, 0) for c in children):
                stop(children)
                print("benchmark: a rank failed", file=sys.stderr,
                      flush=True)
                os._exit(5)
            time.sleep(1.0)

    threading.Thread(target=watch, daemon=True).start()
    return children


def stop(children: list) -> None:
    for c in children:
        if c.poll() is None:
            c.terminate()
    for c in children:
        try:
            c.wait(timeout=20)
        except subprocess.TimeoutExpired:
            c.kill()
            c.wait()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Ranks 1.. of a cell on several cards, started by rank 0.
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not (ROOT / "ray_tpu_torch" / "__init__.py").is_file():
        fail(f"no ray_tpu_torch package in {ROOT}: nothing to measure")
    # Build and kernel caches at fixed paths inside the checkout.
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(1, str(ROOT))

    import torch
    from harness.cell import load_cell
    from harness.session import result_line, run_cell

    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        fail("CUDA is not available: this benchmark measures the card and "
             "does not fall back to the CPU", 3)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} visible", 3)
    torch.cuda.set_device(args.rank)
    children = []
    if cell.chips > 1:
        if args.rank == 0:
            args.port = free_port()
            children = start_ranks(cell.chips, args.port)
        import torch.distributed as dist
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{args.port}", world_size=cell.chips,
                                rank=args.rank)
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), T0)
    except BaseException:
        stop(children)
        raise
    if cell.chips > 1:
        dist.destroy_process_group()
    if args.rank != 0:
        return
    if any(c.wait() != 0 for c in children):
        fail("a rank failed")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out.pop("peak_bytes"),
              "power_limit": power_limit()}
    if args.trace:
        device["busy_s"] = out.pop("busy_s")
        device["window_s"] = out.pop("window_s")
    loaded = forbidden_modules()
    if loaded:
        fail(f"modules of JAX or the JAX package were loaded: {loaded}", 4)
    line = result_line(out, device)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)


if __name__ == "__main__":
    main()
