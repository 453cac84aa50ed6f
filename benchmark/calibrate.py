#!/usr/bin/env python3
"""Readings that set a cell's limits (not run by the benchmark's runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> ... \
        [--control <n> ...] [--fault <n> ...]

For each seed of ``--seeds``: the program's set-up and the steps the
cell's check follows (no window), its readings, then the fp32 reference's, and the check's
numbers between them: the lower readings. ``--control``: the reference
computed with every product in fp8 put in the program's place, against the
fp32 reference: the upper readings. ``--fault``: the program with half of
each batch left out (the mean over the rest). A step that leaves its state
unchanged needs no run: its change reads 1 by the check's measure. One JSON
line a reading on standard output. A cell of several cards runs under
``torchrun --standalone --nproc_per_node <chips>``."""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def half_batch(prog) -> None:
    """Fault: the step sees the first half of each batch's rows."""
    step = prog.step_fn

    def broken(state, batch):
        rows = batch["tokens"].shape[0] // 2
        half = {"tokens": batch["tokens"][:rows]}
        if hasattr(batch, "cut"):      # this rank's rows already
            half = type(batch)(half, batch.cut)
        return step(state, half)
    prog.step_fn = broken


def state_unchanged(prog) -> None:
    """Fault: AdamW counts the step and changes nothing."""
    from ray_tpu_torch.train.train_step import AdamWState
    prog.opt.update = lambda grads, state, params: AdamWState(
        state.mu, state.nu, state.count + 1)


class _Done:
    def wait(self, *args, **kwargs):
        return True

    def is_completed(self):
        return True


def no_exchange(prog) -> None:
    """Fault: gradients are not exchanged between the ranks; each keeps its
    own part of its own gradient where the reduce-scatter would sum them
    (patched only while the program's step runs)."""
    import torch.distributed as dist
    step = prog.step_fn
    names = [n for n in ("reduce_scatter_tensor", "reduce_scatter_single")
             if hasattr(dist, n)]

    def local(output, input, op=None, group=None, async_op=False):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        output.copy_(input.reshape(n, -1)[r].view_as(output))
        return _Done() if async_op else None

    def broken(state, batch):
        saved = {n: getattr(dist, n) for n in names}
        for n in names:
            setattr(dist, n, local)
        try:
            return step(state, batch)
        finally:
            for n, f in saved.items():
                setattr(dist, n, f)
    prog.step_fn = broken


FAULTS = {"half_batch": half_batch, "state_unchanged": state_unchanged,
          "no_exchange": no_exchange}


def program_readings(cell, seed, device, fault=None):
    from harness.program import Program
    from harness.reference import Readings
    from harness.session import global_batch
    from harness.weights import token_pool
    t = cell.traffic
    pool = token_pool(seed, t["pool"], global_batch(cell), t["seq"],
                      cell.spec.vocab)
    prog = Program(cell.spec, t, pool, seed, device)
    if fault is not None:
        fault(prog)
    losses = []
    for i in range(cell.reference_steps):
        losses.append(prog.run_step()["loss"])
        if i == 0:
            grads = prog.grad_norms()
    change = prog.change_norms()
    out = Readings([float(x) for x in losses], grads, change)
    prog.free()
    return out, pool


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=["half_batch"],
                    help="which planted faults the --fault seeds run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(1, str(ROOT))
    os.environ["USE_FLAX"] = "0"
    import torch
    from harness.cell import load_cell
    from harness.check import compare
    from harness.reference import AdamWConfig, run_reference
    from harness.weights import token_pool
    from harness.session import global_batch
    cell = load_cell(ROOT, args.workload)
    t = cell.traffic
    opt = AdamWConfig(t["lr"])
    # A cell of several cards: one process a card (``torchrun
    # --nproc_per_node <chips>``), rank 0 printing.
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if world != cell.chips:
        raise SystemExit(f"{args.workload} runs on {cell.chips} ranks, "
                         f"not {world}")
    device = args.device
    if world > 1:
        import torch.distributed as dist
        if device == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        device = f"cuda:{rank}"
    for seed in sorted(set(args.seeds) | set(args.control)
                       | set(args.fault)):
        t0 = time.time()
        pool = token_pool(seed, t["pool"], global_batch(cell), t["seq"],
                          cell.spec.vocab)
        batches = [torch.from_numpy(pool[i])
                   for i in range(cell.reference_steps)]
        rows = {}
        if seed in args.seeds:
            rows["program"], _ = program_readings(cell, seed, device)
        if seed in args.fault:
            for name in args.faults:
                rows[name], _ = program_readings(cell, seed, device,
                                                 FAULTS[name])
        t1 = time.time()
        ref = run_reference(cell.spec, seed, batches, opt, device)
        t2 = time.time()
        if seed in args.control:
            rows["control"] = run_reference(cell.spec, seed, batches, opt,
                                            device, "fp8")
        for kind, r in rows.items() if rank == 0 else ():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, "numbers": compare(r, ref),
                              "losses": r.losses, "ref_losses": ref.losses,
                              "program_s": round(t1 - t0, 1),
                              "reference_s": round(t2 - t1, 1)}),
                  flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    if world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
