"""One rank of a training run of the port across processes, for
tests/test_torch_dp.py, test_torch_strategies.py, test_torch_ep.py,
test_torch_pipeline.py, test_torch_checkpoint.py, test_torch_collective.py,
test_torch_feed.py (gloo ranks on the CPU) and tests/test_torch_cuda.py
(NCCL ranks, one per card).
Imports torch, numpy and ray_tpu_torch only (no JAX: the tests compute the
reference in their own process).

    python tests/torch_dp_worker.py RANK WORLD STORE_FILE IN.npz OUT.npz [DEVICE]

The rank joins a world through a FileStore at STORE_FILE (DEVICE "cpu",
the default: gloo, every rank on the CPU; "cuda": NCCL, rank r on
cuda:r) and takes the runs that IN.npz lists, in order, in that world.

IN.npz holds ``runs``, a JSON list of runs, each a dict with the keys
``tag`` (prefix of its keys in OUT.npz), ``strategy`` (a preset's name,
or "sp_ep": ``ShardingStrategy.sp_ep()``), ``mesh``
(axis sizes), ``cfg`` (GPTConfig fields over GPTConfig.tiny() in fp32),
``accum_steps``, ``steps``, ``tokens`` and ``params`` (the keys of the
global batch and the prefix of the initial weights ``<params><dotted
name>``, loaded into the placed model's shards by
``convert.load_params``); or ``kind`` "ring" with ``mesh``, ``q``, ``k``, ``v`` and ``w``
(global [B, H, S, D] arrays: ring attention of this rank's sequence shard,
and the gradients of sum(out * w)); or ``kind`` "count" with ``mesh``,
``strategy``, ``cfg``, ``tokens`` and ``policies`` (the all_reduce calls
of one gpt_loss's forward and backward under each remat policy, in
``<policy>``).

A training run may also name ``microbatches`` (the pipeline layout,
``parallel.pipeline``: StackedGPT and make_gpt_pp_loss with that many
microbatches), ``grads`` (record AdamW's gradients and the final local
shards, ``final:<name>``), ``saves`` ({step: directory}: the state saved by
``train.checkpoint`` before that step) and ``restore`` (a directory the
state is loaded from before the first step). ``kind`` "pytree" saves and
loads tests/test_train.py's sharded tree in ``dir``; "collective" runs
tests/test_collective.py's cases through ``util.collective`` on a
``backend`` group; "feed" runs ``data.feed.device_batch_stream`` (its
docstring gives the keys).

A run of ``kind`` "card" (tests/test_torch_cuda.py) trains GPTConfig's
``preset`` ("gpt2_small") with ``cfg`` over it, in ``dtype``, from the
port's init (CPU generator, seed 0) on ``batch`` x ``seq`` tokens from
numpy's seed 1: ``steps`` counted steps (loss, grad norm, host-clock ms,
K1-K3 launches of each), their peak memory, one more step under
torch.profiler (the device ms of its kernels but NCCL's, and NCCL's
kernels' ms apart), and the MoE routing of step 0's forward
(``routing<layer>``, this rank's rows and positions). With
``microbatches`` it trains the pipeline layout; with ``save`` the state is
saved there after the steps and rank 0 writes the gathered final
parameters to ``gathered``.

A training run builds ``build_mesh``, takes ``steps`` AdamW(3e-4) steps
through ``init_train_state``/``make_train_step`` on the global batch, and
evaluates it with ``make_eval_step``. OUT.npz holds, under the run's tag,
each step's ``loss`` and ``grad_norm``, ``eval_loss``, the rank's shards
of the initial weights (``shard:<name>``), the final weights gathered
whole (``param:<name>``), the mesh coordinate (``coord``) and, under
``dp``, the gradients AdamW was given (``grad<i>:<name>``). A ring run
holds ``out``, ``dq``, ``dk`` and ``dv`` of its shard.
"""

import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.models import GPTConfig, convert, gpt_init, gpt_loss
from ray_tpu_torch.ops.attention import ring_attention
from ray_tpu_torch.parallel import MeshConfig, ShardingStrategy, build_mesh
from ray_tpu_torch.parallel.pipeline import (gpt_params_to_pp,
                                             make_gpt_pp_loss)
from ray_tpu_torch.parallel.sharding import local_params
from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree
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


def _strategy(name):
    """A preset's name as is; "sp_ep" as ``ShardingStrategy.sp_ep()``."""
    return ShardingStrategy.sp_ep() if name == "sp_ep" else name


def _train(run, data, devices, result):
    tag = run["tag"]
    cfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32,
                              **run["cfg"])
    accum, steps = run["accum_steps"], run["steps"]
    prefix = run["params"]
    weights = convert.unflatten({k[len(prefix):]: data[k] for k in data.files
                                 if k.startswith(prefix)})
    tokens = torch.from_numpy(data[run["tokens"]]).long()
    strategy = _strategy(run["strategy"])
    mesh = build_mesh(MeshConfig(**run["mesh"]), devices=devices)
    opt = _RecordingAdamW(3e-4)
    init, loss_fn = lambda: gpt_init(cfg, device="cpu"), gpt_loss
    if run.get("microbatches"):
        init = lambda: gpt_params_to_pp(  # noqa: E731
            gpt_init(cfg, device="cpu"))
        loss_fn = make_gpt_pp_loss(cfg, mesh, run["microbatches"])
    # The port's own init, placed; then the given weights into the shards.
    state = init_train_state(init, opt, mesh, strategy)
    convert.load_params(state.params, weights)
    if run.get("restore"):
        state = load_pytree(run["restore"], state=state)
    names = [n for n, _ in state.params.named_parameters()]
    for name, t in zip(names, local_params(state.params)):
        result[f"{tag}shard:{name}"] = t.detach().cpu().numpy().copy()
    step = make_train_step(loss_fn, opt, mesh, strategy, accum_steps=accum)
    losses, norms = [], []
    for i in range(steps):
        if str(i) in run.get("saves", {}):
            save_pytree(state, run["saves"][str(i)])
        state, metrics = step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    flat = tokens.reshape(-1, tokens.shape[-1]) if accum else tokens
    ev = make_eval_step(loss_fn, mesh, strategy)(state.params,
                                                 {"tokens": flat})
    result.update({f"{tag}loss": np.array(losses),
                   f"{tag}grad_norm": np.array(norms),
                   f"{tag}eval_loss": np.array(float(ev)),
                   f"{tag}coord": np.array(list(mesh.coordinate().values()))})
    for name, p in convert.flatten(
            convert.params_to_numpy(state.params)).items():
        result[f"{tag}param:{name}"] = p
    if run["strategy"] == "dp" or run.get("grads"):
        for i, grads in enumerate(opt.seen):
            for name, g in zip(names, grads):
                result[f"{tag}grad{i}:{name}"] = g.cpu().numpy()
    if run.get("grads"):
        for name, t in zip(names, local_params(state.params)):
            result[f"{tag}final:{name}"] = t.detach().cpu().numpy().copy()


def _pytree(run, data, devices, result):
    """tests/test_train.py::test_save_load_pytree_sharded over the world:
    {"w": [8, 4] sharded on dim 0, "b", "meta": {"step": 7}} saved in
    ``dir``, loaded whole and onto dim 1."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    tag = run["tag"]
    mesh = DeviceMesh("cpu", list(range(dist.get_world_size())))
    tree = {"w": distribute_tensor(torch.arange(32.0).reshape(8, 4), mesh,
                                   [Shard(0)]),
            "b": torch.ones(3), "meta": {"step": 7}}
    save_pytree(tree, run["dir"])
    out = load_pytree(run["dir"])
    again = load_pytree(run["dir"], shardings={
        "w": (mesh, [Shard(1)]), "b": (mesh, [Replicate()]),
        "meta": {"step": None}})
    result.update({f"{tag}w": out["w"].numpy(), f"{tag}b": out["b"].numpy(),
                   f"{tag}step": np.array(out["meta"]["step"]),
                   f"{tag}w_local": again["w"].to_local().numpy(),
                   f"{tag}w_full": again["w"].full_tensor().numpy(),
                   f"{tag}b_local": again["b"].to_local().numpy()})


def _collective(run, data, devices, result):
    """tests/test_collective.py's three cases through
    ray_tpu_torch.util.collective on a group of the whole world, gloo or
    NCCL (``backend``); the reducescatter input has ``rs_rows`` rows."""
    from ray_tpu_torch.util import collective as col
    tag, world = run["tag"], dist.get_world_size()
    rank = dist.get_rank()
    name = tag or "g1"
    if run["backend"] == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())

    def say(what):   # progress, in the test's message if a rank hangs
        print(f"[collective] rank {rank}: {what}", flush=True)
    say("joining")
    col.init_collective_group(world, rank, backend=run["backend"],
                              group_name=name)
    say("joined")
    x = np.full((4,), float(rank + 1))
    result[f"{tag}allreduce"] = col.allreduce(x, group_name=name)
    result[f"{tag}max"] = col.allreduce(x, group_name=name,
                                        op=col.ReduceOp.MAX)
    result[f"{tag}bcast"] = col.broadcast(
        np.arange(3.0) if rank == 1 else None, src_rank=1, group_name=name)
    gathered = col.allgather(np.arange(rank + 1), group_name=name)
    result[f"{tag}allgather"] = np.concatenate(gathered)
    result[f"{tag}rs"] = col.reducescatter(
        np.arange(run["rs_rows"] * 2, dtype=np.float64).reshape(-1, 2),
        group_name=name)
    result[f"{tag}reduce"] = col.reduce(x, dst_rank=world - 1,
                                        group_name=name)
    say("collectives done")
    col.barrier(group_name=name)
    say("barrier")

    def links():   # the point-to-point links made so far, [n, 2]
        return np.array(col.pair_links(name), dtype=np.int64).reshape(-1, 2)
    result[f"{tag}links_before_p2p"] = links()
    if rank == 0:
        col.send(np.array([42.0]), dst_rank=1, group_name=name)
    elif rank == 1:
        result[f"{tag}recv"] = col.recv(src_rank=0, group_name=name)
    # Symmetric exchange between partners: every rank sends, then receives.
    say("send/recv 0 -> 1")
    peer = rank ^ 1
    col.send(np.array([float(rank)]), dst_rank=peer, group_name=name)
    result[f"{tag}sym"] = col.recv(src_rank=peer, group_name=name)
    say("symmetric send/recv")
    result[f"{tag}links"] = links()
    tree = {"w": np.ones((2, 2)) * (rank + 1), "b": [np.ones(2) * (rank + 1),
                                                     torch.ones(3) * rank]}
    out = col.allreduce(tree, group_name=name)
    result[f"{tag}tree_w"] = out["w"]
    result[f"{tag}tree_b0"] = out["b"][0]
    result[f"{tag}tree_b1"] = out["b"][1].cpu().numpy()
    col.destroy_collective_group(name)
    say("done")


def _feed(run, data, devices, result):
    """data.feed.device_batch_stream of the batches ``batch<i>:<key>`` on
    each (strategy, mesh, accum_steps) of ``cases`` (under accum_steps each
    reshaped to [accum_steps, rows / accum_steps, ...]): this rank's rows
    of every batch (``<case>/<i>:<key>``); then one train step from the
    first batch so fed and one from the same batch whole, on the first
    case (``step`` holds both losses)."""
    from ray_tpu_torch.data import device_batch_stream
    tag = run["tag"]
    n = run["batches"]
    batches = [{k.split(":", 1)[1]: data[k] for k in data.files
                if k.startswith(f"batch{i}:")} for i in range(n)]
    for c, (strategy, axes, accum) in enumerate(run["cases"]):
        mesh = build_mesh(MeshConfig(**axes), devices=devices)
        # Under accum_steps each batch carries a leading [accum] dim.
        source = [{k: v.reshape((accum, -1) + v.shape[1:]) if accum else v
                   for k, v in b.items()} for b in batches]
        for i, b in enumerate(device_batch_stream(
                iter(source), mesh, _strategy(strategy), accum_steps=accum)):
            for key, t in b.items():
                assert t.device == mesh.device
                result[f"{tag}{c}/{i}:{key}"] = t.numpy()
    strategy, axes, _ = run["cases"][0]
    mesh = build_mesh(MeshConfig(**axes), devices=devices)
    losses = []
    for fed in (True, False):
        cfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32)
        opt = AdamW(3e-4)
        state = init_train_state(lambda: gpt_init(cfg, device="cpu"), opt,
                                 mesh, strategy)
        step = make_train_step(gpt_loss, opt, mesh, strategy)
        batch = {k: torch.from_numpy(v).long() for k, v in batches[0].items()}
        if fed:
            batch = next(device_batch_stream(iter([batches[0]]), mesh,
                                             strategy, dtype=torch.long))
        losses.append(float(step(state, batch)[1]["loss"]))
    result[f"{tag}step"] = np.array(losses)


def _ring(run, data, devices, result):
    """Ring attention of this rank's shard of q, k, v, and the gradients of
    sum(out * w) on it."""
    tag = run["tag"]
    mesh = build_mesh(MeshConfig(**run["mesh"]), devices=devices)
    seq = mesh.axis("sequence")
    dev = mesh.device

    def shard(key):
        full = torch.from_numpy(data[run[key]])
        n = full.shape[2] // seq.size
        return full[:, :, seq.index * n:(seq.index + 1) * n].to(dev)

    q, k, v = (shard(key).requires_grad_() for key in ("q", "k", "v"))
    out = ring_attention(q, k, v, mesh=mesh, causal=True)
    torch.sum(out * shard("w")).backward()
    for key, t in (("out", out), ("dq", q.grad), ("dk", k.grad),
                   ("dv", v.grad)):
        result[f"{tag}{key}"] = t.detach().cpu().numpy()


def _count(run, data, devices, result):
    """all_reduce calls in the forward and in the backward of one gpt_loss
    under each remat policy of ``policies``, in a step on ``mesh``."""
    from ray_tpu_torch.parallel.mesh import data_parallel
    from ray_tpu_torch.parallel.sharding import shard_params
    tag = run["tag"]
    mesh = build_mesh(MeshConfig(**run["mesh"]), devices=devices)
    tokens = torch.from_numpy(data[run["tokens"]]).long()
    calls = []
    all_reduce = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted
    try:
        for policy in run["policies"]:
            cfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32,
                                      remat_policy=policy, **run["cfg"])
            model = gpt_init(cfg, device="cpu")
            shard_params(model, mesh, _strategy(run["strategy"]))
            with data_parallel(mesh, ("data",)):
                calls.clear()
                loss = gpt_loss(model, {"tokens": tokens})
                forward = len(calls)
            # Outside the step's context, as the CUDA autograd engine runs
            # the backward on a thread of its own, which does not inherit it.
            calls.clear()
            loss.backward()
            result[f"{tag}{policy}"] = np.array([forward, len(calls)])
    finally:
        dist.all_reduce = all_reduce


def card_model(run):
    """(config, the whole model on the CPU, the global batch) of a "card"
    run: the same on every rank and in a one-card reference."""
    cfg = dataclasses.replace(getattr(GPTConfig, run["preset"])(),
                              dtype=getattr(torch, run["dtype"]),
                              **run["cfg"])
    model = gpt_init(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (run["batch"], run["seq"] + 1))
    return cfg, model, {"tokens": torch.from_numpy(toks).long()}


def card(run, devices, result, world_of_one=False):
    """A "card" run (module doc) on this rank, or, ``world_of_one``, on the
    first device alone (the one-card reference: same code, every mesh axis
    of size 1)."""
    import time

    import chip_smoke
    from ray_tpu_torch.ops.attention import KERNELS
    tag = run["tag"]
    cfg, model, batch = card_model(run)
    strategy = _strategy(run["strategy"])
    mesh = build_mesh(MeshConfig(**({} if world_of_one else run["mesh"])),
                      devices=devices[:1] if world_of_one else devices)
    cuda = mesh.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    opt = AdamW(3e-4)
    loss_fn = gpt_loss
    if run.get("microbatches"):
        model = gpt_params_to_pp(model)
        loss_fn = make_gpt_pp_loss(cfg, mesh, run["microbatches"])
    state = init_train_state(lambda: model, opt, mesh, strategy)
    step = make_train_step(loss_fn, opt, mesh, strategy)
    routing = {}
    losses, norms, times, launches = [], [], [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(run["steps"]):
        before = [k.launches for k in KERNELS.values()]
        sync()
        t0 = time.perf_counter()
        with chip_smoke._moe_routing(
                state.params, record=routing if i == 0 else None):
            state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
        norms.append(float(metrics["grad_norm"]))
        launches.append([k.launches - b
                         for k, b in zip(KERNELS.values(), before)])
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    device_ms = nccl_ms = 0.0
    if cuda:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, metrics = step(state, batch)
            float(metrics["loss"])
            sync()
        ops = [(e.key, chip_smoke._device_us(e) / 1e3)
               for e in prof.key_averages() if e.device_type.name == "CUDA"]
        # NCCL kernels run on their own streams beside the compute and
        # spin while they wait for the other ranks: kept apart. Each
        # collective also has a "nccl:<op>" range on the device, which
        # counts its kernel a second time.
        nccl_ms = sum(ms for key, ms in ops if key.startswith("ncclDevKernel"))
        device_ms = sum(ms for key, ms in ops if "nccl" not in key.lower())
        result[f"{tag}top"] = np.array([f"{ms:.2f} ms {key[:80]}" for key, ms
                                        in sorted(ops, key=lambda o: -o[1])[:6]])
    result.update({f"{tag}loss": np.array(losses),
                   f"{tag}grad_norm": np.array(norms),
                   f"{tag}step_ms": np.array(times),
                   f"{tag}launches": np.array(launches),
                   f"{tag}peak_gb": np.array(peak),
                   f"{tag}device_ms": np.array(device_ms),
                   f"{tag}nccl_ms": np.array(nccl_ms),
                   f"{tag}coord": np.array(list(mesh.coordinate().values()))})
    for i, idx in routing.items():
        if i != "aux":
            result[f"{tag}routing{i}"] = idx.cpu().numpy()
    if run.get("save") and not world_of_one:
        from ray_tpu_torch.parallel.sharding import gather_params
        save_pytree(state, run["save"])
        whole = {n: p.cpu().numpy() for n, p in
                 gather_params(state.params).items()}
        if dist.get_rank() == 0:
            np.savez(run["gathered"], **whole)
    del state, model
    if cuda:
        torch.cuda.empty_cache()


def run(rank: int, world: int, store: str, inp: str, out: str,
        device: str = "cpu") -> None:
    data = np.load(inp)
    runs = json.loads(str(data["runs"]))
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is fp32
        devices = [f"cuda:{r}" for r in range(world)]
    else:
        devices = ["cpu"] * world
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        result = {}
        for spec in runs:
            if spec.get("kind") == "card":
                card(spec, devices, result)
            else:
                {"ring": _ring, "count": _count, "pytree": _pytree,
                 "collective": _collective, "feed": _feed}.get(
                    spec.get("kind"), _train)(spec, data, devices, result)
        np.savez(out, **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
