"""The port's Train harness (ray_tpu_torch/train: Trainer, the session API,
the worker group and backend executor) against JAX's (ray_tpu/train:
JaxTrainer).

The loops of tests/test_train.py (reports, checkpointing with num_to_keep,
one failure and its retry) run through JaxTrainer and through the port's
Trainer, in process (a gang of one, no runtime) and with runtime=ray_tpu
(the workers are ray_tpu actors, as JAX's are). Held equal: the
metrics_dataframe, the final metrics, the kept checkpoints and their
contents, the error of a loop that always fails, and the retry counts.
The loops are defined inside the tests, so that cloudpickle ships them by
value to the actors, and each imports its train API (JAX's or the port's)
by name inside its body: ray_tpu ships the port's modules by value
(driver-local code), so a loop that closed over the port's module objects
would carry copies of them.
"""

import importlib
import os
import time
import weakref

import pytest

import ray_tpu.train as jtrain
import ray_tpu.train.trainer as jtrainer_mod
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.train import CudaBackendConfig
from ray_tpu_torch.train import trainer as ttrainer_mod

CPU = CudaBackendConfig(platform="cpu")


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu
    ray_tpu.init(num_cpus=4, num_tpus=0)
    yield ray_tpu
    ray_tpu.shutdown()


def _fit(pkg, fn, where, cluster, **kw):
    """fn through JAX's JaxTrainer (pkg jtrain) or the port's Trainer
    (ttrain) in process (where "local") or over ray_tpu actors."""
    if pkg is jtrain:
        return jtrain.JaxTrainer(fn, **kw).fit()
    runtime = cluster if where == "ray_tpu" else None
    return ttrain.Trainer(fn, backend_config=CPU, runtime=runtime,
                          **kw).fit()


def _workers(where, n):
    return n if where == "ray_tpu" else 1


def _api(pkg):
    """What a loop imports: the package's name."""
    return pkg.__name__


@pytest.mark.timeout(120)
@pytest.mark.parametrize("where", ["local", "ray_tpu"])
def test_reports_match_jax(cluster, where):
    def loop(name):
        def train_fn(config):
            pkg = importlib.import_module(name)
            ctx = pkg.get_context()
            for i in range(3):
                pkg.report({"round": i, "rank": ctx.get_world_rank(),
                            "world": ctx.get_world_size(),
                            "local_rank": ctx.get_local_rank(),
                            "lr": config["lr"]})
        return train_fn

    n = _workers(where, 2)
    results = [_fit(pkg, loop(_api(pkg)), where, cluster,
                    train_loop_config={"lr": 0.1},
                    scaling_config=pkg.ScalingConfig(num_workers=n))
               for pkg in (jtrain, ttrain)]
    jax_r, port_r = results
    assert port_r.error is None and jax_r.error is None
    assert port_r.metrics_dataframe == jax_r.metrics_dataframe
    assert port_r.metrics == jax_r.metrics
    assert port_r.metrics == {"round": 2, "rank": 0, "world": n,
                              "local_rank": 0, "lr": 0.1}


@pytest.mark.timeout(120)
@pytest.mark.parametrize("where", ["local", "ray_tpu"])
def test_checkpointing_matches_jax(cluster, where, tmp_path):
    def loop(name):
        def train_fn():
            pkg = importlib.import_module(name)
            ctx = pkg.get_context()
            start = 0
            ckpt = pkg.get_checkpoint()
            if ckpt is not None:
                start = ckpt.to_dict()["round"] + 1
            for i in range(start, 4):
                c = None
                if ctx.get_world_rank() == 0:
                    c = pkg.Checkpoint.from_dict({"round": i})
                pkg.report({"round": i}, checkpoint=c)
        return train_fn

    n = _workers(where, 2)
    out = {}
    for pkg in (jtrain, ttrain):
        r = _fit(pkg, loop(_api(pkg)), where, cluster,
                 scaling_config=pkg.ScalingConfig(num_workers=n),
                 run_config=pkg.RunConfig(
                     name="ckpt_test", storage_path=str(tmp_path / pkg.__name__),
                     checkpoint_config=pkg.CheckpointConfig(num_to_keep=2)))
        # Resume from the best checkpoint: starts at round 4, no rounds.
        r2 = _fit(pkg, loop(_api(pkg)), where, cluster,
                  scaling_config=pkg.ScalingConfig(num_workers=1),
                  resume_from_checkpoint=r.checkpoint)
        out[pkg] = (r, r2)
    (jr, jr2), (pr, pr2) = out[jtrain], out[ttrain]
    assert pr.metrics_dataframe == jr.metrics_dataframe
    assert pr.checkpoint.to_dict() == jr.checkpoint.to_dict() == {"round": 3}
    kept = [[(c.to_dict(), m, os.path.isdir(c.path)) for c, m in
             r.best_checkpoints] for r in (jr, pr)]
    assert kept[1] == kept[0]
    assert [m["round"] for _, m, _ in kept[1]] == [2, 3]
    assert pr2.error is None and pr2.metrics_dataframe == jr2.metrics_dataframe == []


@pytest.mark.timeout(150)
@pytest.mark.parametrize("where", ["local", "ray_tpu"])
def test_failure_and_retry_match_jax(cluster, where, tmp_path):
    def loop(name, marker, attempts):
        def train_fn():
            pkg = importlib.import_module(name)
            with open(attempts, "a") as f:
                f.write("attempt\n")
            ctx = pkg.get_context()
            ckpt = pkg.get_checkpoint()
            start = 0 if ckpt is None else ckpt.to_dict()["round"] + 1
            for i in range(start, 4):
                if i == 2 and not os.path.exists(marker):
                    open(marker, "w").close()
                    raise RuntimeError("boom at round 2")
                c = (pkg.Checkpoint.from_dict({"round": i})
                     if ctx.get_world_rank() == 0 else None)
                pkg.report({"round": i}, checkpoint=c)
        return train_fn

    def always_fail(attempts):
        def train_fn():
            with open(attempts, "a") as f:
                f.write("attempt\n")
            raise ValueError("nope")
        return train_fn

    def count(path):
        with open(path) as f:
            return len(f.readlines())

    seen = {}
    for pkg, errors in ((jtrain, jtrain.TrainingFailedError),
                        (ttrain, ttrain.TrainingFailedError)):
        d = tmp_path / pkg.__name__
        d.mkdir()
        r = _fit(pkg, loop(_api(pkg), str(d / "fail_once"),
                           str(d / "attempts")),
                 where, cluster,
                 scaling_config=pkg.ScalingConfig(num_workers=1),
                 run_config=pkg.RunConfig(
                     name="ft", storage_path=str(d),
                     failure_config=pkg.FailureConfig(max_failures=1)))
        with pytest.raises(errors) as info:
            _fit(pkg, always_fail(str(d / "always")), where, cluster,
                 scaling_config=pkg.ScalingConfig(num_workers=1),
                 run_config=pkg.RunConfig(
                     storage_path=str(d),
                     failure_config=pkg.FailureConfig(max_failures=2)))
        seen[pkg] = (r.error, r.metrics, r.metrics_dataframe,
                     r.checkpoint.to_dict(), count(d / "attempts"),
                     str(info.value).strip().splitlines()[-1],
                     count(d / "always"))
    assert seen[ttrain] == seen[jtrain]
    # Resumed from the round-1 checkpoint: rounds 0, 1, then 2, 3; two
    # attempts; the always-failing loop ran 1 + max_failures times.
    assert seen[ttrain][:3] == (None, {"round": 3},
                                [{"round": i} for i in (0, 1, 2, 3)])
    assert seen[ttrain][4:] == (2, "ValueError: nope", 3)


@pytest.mark.timeout(150)
@pytest.mark.parametrize("where", ["local", "ray_tpu"])
def test_cuda_error_ends_in_process_fit_is_retried_under_a_runtime(
        cluster, where, tmp_path):
    """A CUDA error is sticky: it kills the process's CUDA context. In
    process the port's fit ends after the first attempt, whatever
    FailureConfig says; with runtime=ray_tpu each attempt gets new actor
    processes, and the loop is retried 1 + max_failures times, as JAX's
    JaxTrainer retries it."""
    def cuda_error(attempts):
        def train_fn():
            with open(attempts, "a") as f:
                f.write("attempt\n")
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return train_fn

    def count(path):
        with open(path) as f:
            return len(f.readlines())

    seen = {}
    for pkg in ((jtrain, ttrain) if where == "ray_tpu" else (ttrain,)):
        d = tmp_path / pkg.__name__
        d.mkdir()
        with pytest.raises(pkg.TrainingFailedError) as info:
            _fit(pkg, cuda_error(str(d / "attempts")), where, cluster,
                 scaling_config=pkg.ScalingConfig(num_workers=1),
                 run_config=pkg.RunConfig(
                     storage_path=str(d),
                     failure_config=pkg.FailureConfig(max_failures=2)))
        seen[pkg] = (count(d / "attempts"),
                     str(info.value).strip().splitlines()[-1])
    want = (1 if where == "local" else 3,
            "RuntimeError: CUDA error: an illegal memory access was "
            "encountered")
    assert seen[ttrain] == want
    if where == "ray_tpu":
        assert seen[jtrain] == want


@pytest.mark.parametrize("attr,order,k", [
    (None, "max", None), (None, "max", 1), (None, "max", 2),
    ("score", "max", 1), ("score", "max", 2),
    ("score", "min", 1), ("score", "min", 2),
])
def test_checkpoint_book_matches_jax(tmp_path, attr, order, k):
    """_CheckpointBook case for case: scoring by an attribute (max, min)
    or by recency, num_to_keep 1, 2 and None, the evicted directories
    deleted, latest and best."""
    books = {}
    for pkg, mod in ((jtrain, jtrainer_mod), (ttrain, ttrainer_mod)):
        book = mod._CheckpointBook(pkg.CheckpointConfig(
            num_to_keep=k, checkpoint_score_attribute=attr,
            checkpoint_score_order=order))
        dirs = []
        for i, score in enumerate([0.9, 0.5, 0.7, 0.2, 0.4, 0.5]):
            d = tmp_path / pkg.__name__ / f"c{i}"
            d.mkdir(parents=True)
            dirs.append(str(d))
            book.register(pkg.Checkpoint.from_directory(str(d)),
                          {"score": score, "i": i})
        books[pkg] = (
            [(s, q, os.path.basename(c.path), m) for s, q, c, m in
             sorted(book.entries, key=lambda e: e[1])],
            os.path.basename(book.latest().path),
            os.path.basename(book.best().path),
            [os.path.isdir(d) for d in dirs])
    assert books[ttrain] == books[jtrain]
    assert sum(books[ttrain][3]) == (6 if k is None else k)


def test_checkpoint_book_empty_matches_jax():
    for mod, pkg in ((jtrainer_mod, jtrain), (ttrainer_mod, ttrain)):
        book = mod._CheckpointBook(pkg.CheckpointConfig())
        assert book.latest() is None and book.best() is None


@pytest.mark.parametrize("kw", [dict(checkpoint_score_order="mean"),
                                dict(num_to_keep=0), dict(num_to_keep=-2)])
def test_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as jax_err:
        jtrain.CheckpointConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        ttrain.CheckpointConfig(**kw)
    assert str(port_err.value) == str(jax_err.value)


def test_configs_match_jax():
    """FailureConfig, CheckpointConfig and RunConfig are JAX's fields and
    defaults; ScalingConfig's differ where a worker owns one card."""
    import dataclasses
    for name in ("FailureConfig", "CheckpointConfig", "RunConfig"):
        fields = [(f.name, f.default) for f in dataclasses.fields(
            getattr(ttrain, name))]
        assert fields == [(f.name, f.default) for f in dataclasses.fields(
            getattr(jtrain, name))], name
    s = ttrain.ScalingConfig(num_workers=3, use_gpu=True)
    assert s.worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert s.as_placement_group_bundles() == [{"CPU": 1.0, "GPU": 1.0}] * 3
    assert ttrain.ScalingConfig(resources_per_worker={"mem": 2}) \
        .worker_resources() == {"mem": 2.0, "CPU": 0.0}
    assert ttrain.ScalingConfig().worker_resources() == \
        jtrain.ScalingConfig().worker_resources() == {"CPU": 1.0}


def test_many_workers_without_runtime_raises():
    """No runtime means a gang of one in this process: the port starts no
    processes of its own."""
    trainer = ttrain.Trainer(lambda: None, backend_config=CPU,
                             scaling_config=ttrain.ScalingConfig(
                                 num_workers=2))
    with pytest.raises(ValueError, match="needs a runtime"):
        trainer.fit()


def test_card_is_the_default(monkeypatch):
    """The backend binds each worker's card unless the caller asks for the
    CPU: without CUDA the default raises, and so does use_gpu=True."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.Trainer(lambda: None).fit()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.Trainer(lambda: None, scaling_config=ttrain.ScalingConfig(
            use_gpu=True)).fit()
    with pytest.raises(ValueError, match="platform='cpu' runs on none"):
        ttrain.Trainer(lambda: None, backend_config=CPU,
                       scaling_config=ttrain.ScalingConfig(
                           use_gpu=True)).fit()
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ttrain.Trainer(lambda: None, backend_config=CudaBackendConfig(
            platform="tpu")).fit()


def test_session_api_outside_and_inside_a_worker():
    """Outside a worker the session calls behave as JAX's; inside, the
    context, the dataset shard and save requests reach the loop."""
    for pkg in (jtrain, ttrain):
        assert pkg.get_checkpoint() is None
        assert pkg.should_checkpoint() is False
        assert pkg.get_context().get_world_size() == 1
        with pytest.raises(RuntimeError, match="outside a train worker"):
            pkg.report({"x": 1})
        with pytest.raises(RuntimeError, match="outside a train worker"):
            pkg.get_dataset_shard()

    def loop():
        ctx = ttrain.get_context()
        ttrain.report({"shard": list(ttrain.get_dataset_shard("train")),
                       "save": ttrain.should_checkpoint(),
                       "env": [os.environ[k] for k in (
                           "RANK", "WORLD_SIZE", "LOCAL_RANK")],
                       "trial": ctx.get_trial_id()})
        with pytest.raises(KeyError, match="no dataset shard named 'eval'"):
            ttrain.get_dataset_shard("eval")

    r = ttrain.Trainer(loop, backend_config=CPU,
                       datasets={"train": [1, 2, 3]}).fit()
    assert r.metrics == {"shard": [1, 2, 3], "save": False,
                         "env": ["0", "1", "0"], "trial": "attempt_0"}

    def waits_for_a_save_request():
        ttrain.report({"save": ttrain.should_checkpoint()})
        deadline = time.monotonic() + 30
        while not ttrain.should_checkpoint() and time.monotonic() < deadline:
            time.sleep(0.01)
        ttrain.report({"save": ttrain.should_checkpoint()})

    ex = ttrain.BackendExecutor(ttrain.ScalingConfig(), CPU)
    ex.start()
    try:
        ex.start_training(waits_for_a_save_request, None)
        first = ex.get_next_results(timeout=30)[0]["metrics"]
        ex.request_save()
        second = ex.get_next_results(timeout=30)[0]["metrics"]
        assert (first, second) == ({"save": False}, {"save": True})
        assert ex.get_next_results(timeout=30) is None
    finally:
        ex.shutdown()


def test_in_process_restart_frees_the_failed_attempt(tmp_path):
    """The gang of one in process: the failed attempt's objects are freed
    before the next attempt's loop starts."""
    class Big:
        pass

    refs = []

    def loop():
        obj = Big()
        refs.append(weakref.ref(obj))
        if len(refs) == 1:
            raise RuntimeError("first attempt fails")
        ttrain.report({"first_alive": refs[0]() is not None})

    r = ttrain.Trainer(loop, backend_config=CPU, run_config=ttrain.RunConfig(
        storage_path=str(tmp_path),
        failure_config=ttrain.FailureConfig(max_failures=1))).fit()
    assert r.metrics == {"first_alive": False}
    assert len(refs) == 2


def test_rendezvous_binds_its_own_port():
    """The gang meets at a store that worker 0 binds itself (on port 0 the
    bind picks the port), so no port is probed and released before the
    rendezvous: JAX's TorchConfig probes a free port and releases it, and
    a port taken in that window fails the rendezvous with EADDRINUSE,
    shown here by asking for a taken port. The torchrun environment is the
    store's, and it is put back when the gang of one in this process
    shuts down."""
    import socket

    import torch.distributed as dist

    def loop():
        ttrain.report({"group": dist.is_initialized() and
                       dist.get_world_size(), "port": os.environ[
                           "MASTER_PORT"], "rank": os.environ["RANK"]})

    before = {k: os.environ.get(k) for k in ("RANK", "MASTER_PORT")}
    forced = CudaBackendConfig(distributed="force", platform="cpu")
    r = ttrain.Trainer(loop, backend_config=forced).fit()
    assert r.metrics["group"] == 1 and r.metrics["rank"] == "0"
    assert int(r.metrics["port"]) > 0
    assert not dist.is_initialized()
    assert {k: os.environ.get(k) for k in before} == before

    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        with pytest.raises(Exception, match="EADDRINUSE|address already"):
            ttrain.Trainer(loop, backend_config=CudaBackendConfig(
                distributed="force", platform="cpu",
                coordinator_port=port)).fit()
    assert not dist.is_initialized()
    assert {k: os.environ.get(k) for k in before} == before
