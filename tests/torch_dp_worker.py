"""One rank of a data-parallel training run of the port, for
tests/test_torch_dp.py (gloo ranks on the CPU) and tests/test_torch_cuda.py
(NCCL ranks, one per card). Imports torch, numpy and ray_tpu_torch only
(no JAX: the tests compute the reference in their own process).

    python tests/torch_dp_worker.py RANK WORLD STORE_FILE IN.npz OUT.npz [DEVICE]

IN.npz holds the config (``n_experts``, ``remat_policy``, ``accum_steps``,
``steps``), the global batch (``tokens``) and the initial weights
(``param:<dotted name>``). The rank joins a world through a FileStore at
STORE_FILE (DEVICE "cpu", the default: gloo, every rank on the CPU;
"cuda": NCCL, rank r on cuda:r), builds ``build_mesh(MeshConfig(
data=WORLD), devices)``, takes ``steps`` AdamW(3e-4) steps through
``init_train_state``/``make_train_step(..., mesh, "dp")`` on the global
batch, then evaluates it with ``make_eval_step``. OUT.npz holds each
step's metrics and the gradients AdamW was given, the eval loss, and the
final weights.
"""

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.models import GPTConfig, gpt_init, gpt_loss
from ray_tpu_torch.parallel import MeshConfig, build_mesh
from ray_tpu_torch.train import (AdamW, init_train_state, make_eval_step,
                                 make_train_step)


class _RecordingAdamW(AdamW):
    """AdamW that keeps a copy of the gradients of each update."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seen = []

    def update(self, grads, state, params):
        self.seen.append([g.detach().clone() for g in grads])
        return super().update(grads, state, params)


def run(rank: int, world: int, store: str, inp: str, out: str,
        device: str = "cpu") -> None:
    data = np.load(inp)
    cfg = dataclasses.replace(
        GPTConfig.tiny(), dtype=torch.float32,
        n_experts=int(data["n_experts"]),
        remat_policy=str(data["remat_policy"]))
    accum, steps = int(data["accum_steps"]), int(data["steps"])
    weights = {k[len("param:"):]: torch.from_numpy(data[k])
               for k in data.files if k.startswith("param:")}
    tokens = torch.from_numpy(data["tokens"]).long()

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is fp32
        devices = [f"cuda:{r}" for r in range(world)]
    else:
        devices = ["cpu"] * world
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = build_mesh(MeshConfig(data=world), devices=devices)

        def init():
            model = gpt_init(cfg, device="cpu")
            model.load_state_dict(weights)
            return model

        opt = _RecordingAdamW(3e-4)
        state = init_train_state(init, opt, mesh, "dp")
        step = make_train_step(gpt_loss, opt, mesh, "dp", accum_steps=accum)
        losses, norms = [], []
        for _ in range(steps):
            state, metrics = step(state, {"tokens": tokens})
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        flat = tokens.reshape(-1, tokens.shape[-1]) if accum else tokens
        ev = make_eval_step(gpt_loss, mesh, "dp")(state.params,
                                                  {"tokens": flat})
        names = [n for n, _ in state.params.named_parameters()]
        result = {"loss": np.array(losses), "grad_norm": np.array(norms),
                  "eval_loss": np.array(float(ev))}
        for name, p in state.params.named_parameters():
            result[f"param:{name}"] = p.detach().cpu().numpy()
        for i, grads in enumerate(opt.seen):
            for name, g in zip(names, grads):
                result[f"grad{i}:{name}"] = g.cpu().numpy()
        np.savez(out, **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
