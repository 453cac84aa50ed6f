"""The port's spans (``ray_tpu_torch.util.spans``) in the train step and
FSDP2's collectives, on the CPU.

Spans record only under ``torch.profiler``: without it a step records
nothing and makes no device event. Under it, one step records ``step`` and
inside it ``forward``, ``backward`` (a pair a microbatch; none inside the
pipeline's loss, which runs its own backward), ``reduce``, ``grad_norm``
and ``update``, in that order, with their parent and the step's number;
the feed records none; two gloo ranks of an
FSDP step record every all-gather and reduce-scatter with the bytes the
model's parameter sizes give. Where CUDA is initialised a span records a
pair of events; here a stand-in for ``torch.cuda.Event`` on the host clock
takes their place."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.data.feed import device_batch_stream
from ray_tpu_torch.models import GPTConfig, gpt_init, gpt_loss
from ray_tpu_torch.train.train_step import (AdamW, init_train_state,
                                            make_train_step)
from ray_tpu_torch.util import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = ["step", "forward", "backward", "reduce", "grad_norm", "update"]


def tiny(**over):
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                max_seq=16, dtype=torch.float32)
    return GPTConfig(**dict(base, **over))


def tokens(rows, seq=8, vocab=64, lead=()):
    gen = torch.Generator().manual_seed(0)
    return torch.randint(0, vocab, lead + (rows, seq + 1), generator=gen)


class HostEvent:
    """``torch.cuda.Event``'s surface on the host clock, counting the
    events made."""
    made = 0

    def __init__(self, enable_timing=False):
        HostEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


@pytest.fixture
def events(monkeypatch):
    """CUDA seen as initialised, its events on the host clock."""
    HostEvent.made = 0
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    return HostEvent


def since(t0):
    return spans.recorded(t0)


def one_step(accum_steps=0, profiled=True):
    torch.manual_seed(0)
    opt = AdamW(3e-4)
    state = init_train_state(lambda: gpt_init(tiny(), device="cpu"), opt)
    step = make_train_step(gpt_loss, opt, accum_steps=accum_steps)
    lead = (accum_steps,) if accum_steps else ()
    feed = device_batch_stream(iter([{"tokens": tokens(4, lead=lead)}]),
                               device="cpu", accum_steps=accum_steps)
    t0 = time.time_ns()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            state, metrics = step(state, next(feed))
    else:
        state, metrics = step(state, next(feed))
    return t0, metrics


def test_no_span_and_no_event_without_the_profiler(events):
    t0, metrics = one_step(profiled=False)
    assert metrics["step"] == 1
    assert since(t0) == []
    assert events.made == 0
    assert spans._open == []


def test_a_dp_step_records_its_phases_in_order(events):
    t0, _ = one_step()
    got = since(t0)
    assert [s.name for s in got] == STEP
    step, *inner = got
    assert step.parent is None and step.step == 1
    assert all(s.parent == step.id and s.step == 1 for s in inner)
    for a, b in zip(got, got[1:]):
        assert a.start_ns <= b.start_ns
    for s in inner:
        assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
    assert not any(s.counts for s in got)    # no collective on one rank
    # A pair of events a span, read after the step.
    assert events.made == 2 * len(got)
    for s in got:
        assert 0 < s.device_ns() <= s.host_ns
    assert spans._open == []


def test_a_collectives_bytes_are_reckoned_only_while_recording():
    class Buffer:
        sized = 0

        def numel(self):
            Buffer.sized += 1
            return 6

        def element_size(self):
            return 4

    buf = Buffer()
    t0 = time.time_ns()
    with spans.span("all_reduce", tensor=buf):
        pass
    assert Buffer.sized == 0 and since(t0) == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("all_reduce", tensor=buf):
            pass
    (got,) = since(t0)
    assert Buffer.sized == 1 and got.counts == {"bytes": 24}


def test_accumulation_records_a_pair_a_microbatch():
    t0, _ = one_step(accum_steps=2)
    got = since(t0)
    assert [s.name for s in got] == ["step", "forward", "backward",
                                     "forward", "backward", "reduce",
                                     "grad_norm", "update"]
    assert all(s.parent == got[0].id for s in got[1:])
    assert all(s.device_ns() == s.host_ns for s in got)   # no events


def test_the_pipeline_loss_records_the_step_around_its_own_pass():
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.pipeline import (gpt_params_to_pp,
                                                 make_gpt_pp_loss)
    cfg = tiny()
    mesh = build_mesh(MeshConfig(data=1, pipeline=1), devices=["cpu"])
    torch.manual_seed(0)
    opt = AdamW(3e-4)
    state = init_train_state(
        lambda: gpt_params_to_pp(gpt_init(cfg, device="cpu")), opt, mesh,
        "pp")
    step = make_train_step(make_gpt_pp_loss(cfg, mesh, 2), opt, mesh, "pp")
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, {"tokens": tokens(4)})
    got = since(t0)
    assert [s.name for s in got] == ["step", "reduce", "grad_norm",
                                     "update"]
    assert all(s.parent == got[0].id and s.step == 1 for s in got[1:])


# ---- two gloo ranks of an FSDP step -----------------------------------------

def fsdp_rank(rank: int, world: int, port: int, out: str) -> None:
    """One rank: a step of the tiny GPT under FSDP2 over ``world`` ranks,
    profiled; rank 0 writes its collectives' spans and the unsharded bytes
    of each FSDP2 unit's parameters (each layer, then the root's own)."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    cfg = tiny()
    mesh = build_mesh(MeshConfig(data=1, fsdp=world), devices=["cpu"] * world)
    torch.manual_seed(0)
    model = gpt_init(cfg, device="cpu")
    units = [sum(p.numel() * p.element_size() for p in layer.parameters())
             for layer in model.layers]
    units.append(sum(p.numel() * p.element_size()
                     for p in model.parameters()) - sum(units))
    opt = AdamW(3e-4)
    state = init_train_state(lambda: model, opt, mesh, "fsdp")
    step = make_train_step(gpt_loss, opt, mesh, "fsdp")
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, {"tokens": tokens(2 * world)})
    got = spans.recorded(t0)
    names = {s.id: s.name for s in got}
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"units": units, "spans": [
                [s.name, s.counts.get("bytes"), names.get(s.parent), s.step]
                for s in got]}, f)
    dist.destroy_process_group()


def test_fsdp_collectives_are_recorded_with_their_bytes(tmp_path):
    world = 2
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = tmp_path / "rank0.json"
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world),
                               str(port), str(out)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    res = json.loads(out.read_text())
    units, got = res["units"], res["spans"]
    layers, root = units[:-1], units[-1]
    gathers = [(b, parent) for name, b, parent, _ in got
               if name == "all_gather"]
    scatters = [(b, parent) for name, b, parent, _ in got
                if name == "reduce_scatter"]
    # Gathers: the root once (it keeps its weights from the forward to the
    # backward), each layer in the forward and again for the backward's
    # recompute; one reduce-scatter a unit, all in the backward.
    assert sorted(b for b, _ in gathers) == sorted([root] + 2 * layers)
    assert [p for _, p in gathers].count("forward") == 1 + len(layers)
    assert [p for _, p in gathers].count("backward") == len(layers)
    assert sorted(b for b, _ in scatters) == sorted(units)
    assert {p for _, p in scatters} == {"backward"}
    # The step's own sums: the loss over the batch group, the norm's sum of
    # squares over fsdp; 4 bytes each.
    sums = [(b, parent) for name, b, parent, _ in got if name == "all_reduce"]
    assert sums == [(4, "reduce"), (4, "grad_norm")]
    assert {s for *_, s in got} == {1}


if __name__ == "__main__":
    fsdp_rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
              sys.argv[4])
