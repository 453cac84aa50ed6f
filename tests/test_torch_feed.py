"""Parity: ray_tpu_torch.data.feed.device_batch_stream against
ray_tpu.data.iterator.jax_batch_stream with
ray_tpu.parallel.sharding.batch_sharding.

The JAX package's Dataset.iter_batches (on the conftest's shared
single-node runtime) makes the numpy batches (two of 16 rows of [33]
tokens, from numpy's seed 3); eight gloo ranks of
tests/torch_dp_worker.py feed them through the port's function for each
preset on its test mesh, and each rank's rows must equal, bit for bit, the
shard that JAX's device_put of the same batch puts on the device at the
same mesh coordinate. "sp" is left out: JAX's splits the tokens' dim 1
over 'sequence', which the GPT batch [B, S+1] cannot take (ROADMAP R-2);
the port splits the tokens inside the model. With accum_steps the rows are
dim 1 (JAX's spec with a leading None). The same launch holds one train
step from a fed batch to the step from the whole batch, bit for bit.
"""

import numpy as np
import pytest

from test_torch_strategies import launch

# (strategy, mesh, accum_steps)
CASES = [
    ("dp", dict(data=8), 0),
    ("fsdp", dict(data=2, fsdp=4), 0),
    ("tp", dict(data=2, tensor=4), 0),
    ("tp_fsdp", dict(data=2, fsdp=2, tensor=2), 0),
    ("pp", dict(data=2, pipeline=4), 0),
    ("pp_tp", dict(data=2, pipeline=2, tensor=2), 0),
    ("fsdp", dict(data=2, fsdp=4), 2),
]
IDS = ["dp", "fsdp", "tp", "tp_fsdp", "pp", "pp_tp", "fsdp-accum"]
N_BATCHES = 2


@pytest.fixture(scope="module")
def env(jax_cpu, ray_shared, tmp_path_factory):
    import ray_tpu.data as rd
    toks = np.random.default_rng(3).integers(0, 512, (32, 33))
    ds = rd.from_items([{"tokens": row} for row in toks])
    batches = list(ds.iter_batches(batch_size=16, batch_format="numpy"))
    assert len(batches) == N_BATCHES
    arrays = {f"batch{i}:{k}": v for i, b in enumerate(batches)
              for k, v in b.items()}
    # Under accum_steps each batch carries a leading [accum] dim.
    accum = [{k: v.reshape((2, -1) + v.shape[1:]) for k, v in b.items()}
             for b in batches]
    run = dict(kind="feed", tag="", batches=N_BATCHES,
               cases=[list(c) for c in CASES])
    ranks = launch(tmp_path_factory.mktemp("feed"), [run], arrays)
    return dict(batches=batches, accum=accum, ranks=ranks, toks=toks)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_feed_rows_match_jax_shards(env, case):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.data.iterator import jax_batch_stream
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.parallel.sharding import batch_sharding
    strategy, axes, accum = CASES[case]
    devices = jax.devices()[:8]
    mesh = build_mesh(MeshConfig(**axes), devices=devices)
    sharding = batch_sharding(mesh, strategy)
    source = env["batches"]
    if accum:
        sharding = NamedSharding(mesh, P(None, *sharding.spec))
        source = env["accum"]
    for i, b in enumerate(jax_batch_stream(iter(source), sharding)):
        for key, arr in b.items():
            by_dev = {s.device: np.asarray(s.data)
                      for s in arr.addressable_shards}
            for r, out in enumerate(env["ranks"]):
                got = out[f"{case}/{i}:{key}"]
                np.testing.assert_array_equal(got, by_dev[devices[r]])


def test_fed_batch_steps_as_the_whole_batch(env):
    for out in env["ranks"]:
        fed, whole = out["step"]
        assert fed == whole


def test_batch_cut_for_another_plan_raises():
    """A LocalBatch holds one plan's rows: a step of another plan refuses
    it rather than taking the wrong rows; in a world of one the fed batch
    is the whole batch, on the device asked for."""
    import torch

    from ray_tpu_torch.data import device_batch_stream
    from ray_tpu_torch.models import GPTConfig, gpt_init, gpt_loss
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    from ray_tpu_torch.train.train_step import LocalBatch
    toks = np.random.default_rng(3).integers(0, 512, (4, 33))
    fed = next(device_batch_stream(iter([{"tokens": toks}]), device="cpu",
                                   dtype=torch.long))
    assert fed.cut == (0, 1, 0) and fed["tokens"].dtype == torch.long
    assert torch.equal(fed["tokens"], torch.from_numpy(toks))
    opt = adamw(3e-4)
    state = init_train_state(lambda: gpt_init(GPTConfig.tiny(),
                                              device="cpu"), opt)
    step = make_train_step(gpt_loss, opt, accum_steps=2)
    with pytest.raises(ValueError, match="the batch was cut as"):
        step(state, LocalBatch(dict(fed), (0, 1, 0)))
