"""Multi-process gang correctness check: the counterpart of
``ray_tpu/parallel/mp_check.py``.

One FIXED dp x fsdp GPT train-step workload, so that
 a) one process on one device, and
 b) a gang of n processes, one device each, over a data x fsdp mesh
compute the SAME loss: the sharded multi-process step (FSDP2 over fsdp,
gradients summed over data) against the whole batch in one process.

A torch process owns exactly one device, so the JAX module's
``local_devices > 1`` (several devices per process) has no counterpart:
every entry point here raises on it. The gang joins through
``torch.distributed`` at a ``tcp://`` address on this host: NCCL on the
cards (rank r on cuda:r), the default, or gloo on the CPU where the caller
gives ``platform="cpu"``.

    python -m ray_tpu_torch.parallel.mp_check RANK N HOST:PORT \\
        LOCAL_DEVICES DATA FSDP [cuda|cpu [DTYPE [WEIGHTS.npz]]]
"""

from __future__ import annotations

import datetime
import os
import re
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# Fixed workload: deterministic config + data seed shared by every mode.
_VOCAB, _SEQ, _BATCH, _STEPS = 512, 64, 8, 2
_DATA_SEED = 7


def _one_device(local_devices: int) -> None:
    if local_devices != 1:
        raise ValueError(
            f"local_devices={local_devices}: a torch process owns exactly "
            "one device; run one process per device")


def step_loss(data_axis: int, fsdp_axis: int, device=None,
              weights: Optional[Dict[str, np.ndarray]] = None,
              dtype: torch.dtype = torch.bfloat16) -> float:
    """Run the fixed data x fsdp workload in this process's world (one
    process, or every rank of a gang with the same arguments) and return
    the step-_STEPS loss, the same on every rank.

    ``weights``: {dotted name: array} to start from (default: the port's
    own init from seed 0); ``device``: this rank's device (default: the
    card); ``dtype``: the activations' (the JAX workload's bf16 by
    default; each rank then rounds its own rows' weight gradients to bf16,
    so only fp32 holds a gang to the one-process loss bit for bit up to
    fp32 summation order)."""
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init, gpt_loss
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.train.train_step import (adamw, init_train_state,
                                                make_train_step)

    world = dist.get_world_size() if dist.is_initialized() else 1
    cpu = resolve_device(device).type == "cpu"
    cfg = GPTConfig(vocab_size=_VOCAB, d_model=128, n_layers=2, n_heads=4,
                    d_ff=256, max_seq=_SEQ, dtype=dtype)
    # On cards: rank r on cuda:r, build_mesh's default.
    mesh = build_mesh(MeshConfig(data=data_axis, fsdp=fsdp_axis),
                      devices=["cpu"] * world if cpu else None)

    def init():
        gen = torch.Generator(device="cpu").manual_seed(0)
        model = gpt_init(cfg, device="cpu", generator=gen)
        if weights is not None:
            model.load_state_dict({k: torch.from_numpy(np.array(v))
                                   for k, v in weights.items()})
        return model

    opt = adamw(1e-3)
    state = init_train_state(init, opt, mesh, "fsdp")
    step = make_train_step(gpt_loss, opt, mesh, "fsdp")
    tokens = torch.from_numpy(np.random.RandomState(_DATA_SEED).randint(
        0, cfg.vocab_size, (_BATCH, _SEQ + 1))).long()
    m = None
    for _ in range(_STEPS):
        state, m = step(state, {"tokens": tokens})
    return float(m["loss"])


def init_process(rank: int, num_processes: int, coordinator: str,
                 local_devices: int, platform: str = "cuda",
                 timeout: Optional[datetime.timedelta] = None,
                 store: Optional[dist.Store] = None) -> None:
    """Join this process to the gang: NCCL on the cards (``platform``
    "cuda"), gloo on the CPU ("cpu"). ``timeout``: of the rendezvous and
    of every collective (torch's default where None). ``store``: the
    gang's rendezvous store, in place of one at ``coordinator``; with it a
    gang of one forms a group too."""
    _one_device(local_devices)
    kw = {} if timeout is None else {"timeout": timeout}
    backend = "gloo" if platform == "cpu" else "nccl"
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=num_processes, **kw)
    elif num_processes > 1:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", rank=rank,
            world_size=num_processes, **kw)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_gang_subprocesses(n_processes: int, local_devices: int,
                          data_axis: int, fsdp_axis: int,
                          timeout: float = 420.0, platform: str = "cuda",
                          dtype: str = "bfloat16",
                          weights_path: Optional[str] = None) -> List[float]:
    """Spawn n worker processes, one device each (``platform`` "cuda":
    rank r on cuda:r, or "cpu"), run the fixed workload (``step_loss``'s
    ``dtype`` and ``weights``, from an npz file) over their data x fsdp
    mesh; return every process's loss."""
    _one_device(local_devices)
    if platform == "cuda":
        from ray_tpu_torch import resolve_device
        resolve_device(None)
        if torch.cuda.device_count() < n_processes:
            raise ValueError(f"{n_processes} processes need as many cards; "
                             f"the host has {torch.cuda.device_count()}")
    elif platform != "cpu":
        raise ValueError(f"platform {platform!r}: 'cuda' or 'cpu'")
    port = free_port()
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    extra = [platform, dtype] + ([weights_path] if weights_path else [])
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.parallel.mp_check",
             str(rank), str(n_processes), f"127.0.0.1:{port}",
             str(local_devices), str(data_axis), str(fsdp_axis), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for rank in range(n_processes)
    ]
    losses: List[Optional[float]] = [None] * n_processes
    outputs: List[str] = [""] * n_processes
    deadline = time.monotonic() + timeout
    try:
        # Poll every worker: waiting in rank order would wedge on rank 0
        # (blocked in the rendezvous) when a later rank crashed.
        pending = set(range(n_processes))
        failed = None
        while pending and time.monotonic() < deadline:
            for rank in list(pending):
                if procs[rank].poll() is None:
                    continue
                outputs[rank] = procs[rank].communicate()[0] or ""
                pending.discard(rank)
                for line in outputs[rank].splitlines():
                    mo = re.match(
                        r"MP_CHECK rank=(\d+) loss=([-\d.naninfe+]+)", line)
                    if mo:
                        losses[rank] = float(mo.group(2))
                if procs[rank].returncode != 0 and losses[rank] is None:
                    failed = rank
            if failed is not None:
                break
            if pending:
                time.sleep(0.2)
        if failed is not None:
            tail = "\n".join(outputs[failed].strip().splitlines()[-6:])
            raise RuntimeError(f"gang worker {failed} failed "
                               f"rc={procs[failed].returncode}:\n{tail}")
        if pending:
            raise RuntimeError(f"gang workers {sorted(pending)} still running "
                               f"at the {timeout:.0f}s deadline "
                               "(rendezvous hang?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    missing = [r for r, x in enumerate(losses) if x is None]
    if missing:
        tails = "\n---\n".join("\n".join(o.strip().splitlines()[-4:])
                               for o in outputs)
        raise RuntimeError(f"gang workers {missing} produced no loss:\n"
                           f"{tails}")
    return [x for x in losses if x is not None]


def main(argv: List[str]) -> None:
    rank, nprocs, coordinator, local_devices, data_axis, fsdp_axis = (
        int(argv[0]), int(argv[1]), argv[2], int(argv[3]), int(argv[4]),
        int(argv[5]))
    platform = argv[6] if len(argv) > 6 else "cuda"
    dtype = getattr(torch, argv[7]) if len(argv) > 7 else torch.bfloat16
    weights = dict(np.load(argv[8])) if len(argv) > 8 else None
    init_process(rank, nprocs, coordinator, local_devices, platform)
    try:
        loss = step_loss(data_axis, fsdp_axis,
                         device="cpu" if platform == "cpu" else "cuda",
                         weights=weights, dtype=dtype)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # repr: every digit, so that the gang compares at full precision.
    print(f"MP_CHECK rank={rank} loss={loss!r}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
