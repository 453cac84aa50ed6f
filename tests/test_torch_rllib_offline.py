"""Parity: the port's offline RL pieces against ray_tpu.rllib's — the
``offline.py`` copy (JsonWriter, JsonReader), MARWIL's ``_returns_to_go``,
and the BC and MARWIL updates with their row draws and ``evaluate``.

The JAX algorithms keep their updates inside ``build_learner`` /
``training_step``; each case builds one without a cluster
(``Algorithm.__new__``, its ``algo_config`` set, ``build_learner()``) and
calls ``training_step``, while the port's learner, holding the JAX
weights, draws its rows with ``sample`` and takes ``update``. Bounds are
tests/torch_rllib_parity.py's; the copies and returns are held exactly.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import convert
from ray_tpu_torch.rllib import offline as toff
from ray_tpu_torch.rllib import sample_batch as tsb
from ray_tpu_torch.rllib.algorithms import bc as tbc
from ray_tpu_torch.rllib.algorithms import marwil as tmarwil
from ray_tpu_torch.rllib.models import policy_value_apply
from torch_rllib_parity import (assert_adam_update_close, close, np_tree,
                                one_torch_thread)  # noqa: F401

LR = 5e-4
HIDDEN = (16, 16)
BATCH = 32


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _fragments(n_frags=3, rows=64, seed=0):
    """CartPole-shaped fragments: reward 1 a step, episodes ended by
    TERMINATEDS, as an EnvRunner writes them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_frags):
        out.append({
            "obs": rng.standard_normal((rows, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, rows),
            "rewards": np.ones(rows, np.float32),
            "terminateds": rng.random(rows) < 0.03,
            "next_obs": rng.standard_normal((rows, 4)).astype(np.float32)})
    return out


def _write(writer_cls, path, frags, max_file_size):
    w = writer_cls(str(path), max_file_size=max_file_size)
    for f in frags:
        w.write(f)
    w.close()


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_offline_copy_matches_reference(jx, tmp_path):
    """Both writers make the same files (rotated by size); each reader
    reads either package's files to the same batches in the same shuffled
    order, and ``next`` draws the same batches."""
    from ray_tpu.rllib import offline as joff
    frags = _fragments(n_frags=5, rows=6)
    _write(joff.JsonWriter, tmp_path / "jax", frags, 2000)
    _write(toff.JsonWriter, tmp_path / "port", frags, 2000)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) > 1
    assert names == sorted(os.listdir(tmp_path / "port"))
    for n in names:
        assert filecmp.cmp(tmp_path / "jax" / n, tmp_path / "port" / n,
                           shallow=False)
    for d in ("jax", "port"):
        path = str(tmp_path / d)
        j, t = joff.JsonReader(path, seed=3), toff.JsonReader(path, seed=3)
        jb, tb = list(j.iter_batches()), list(t.iter_batches())
        assert len(jb) == len(tb) == 5
        for a, b in zip(tb, jb):
            _same(a, b)
        for _ in range(6):
            _same(t.next(), j.next())
        _same(toff.JsonReader(path, seed=1).read_all(),
              joff.JsonReader(path, seed=1).read_all())
        _same(toff.JsonReader(path + "/*.json", shuffle=False).read_all(),
              joff.JsonReader(path + "/*.json", shuffle=False).read_all())
    with pytest.raises(FileNotFoundError, match="no offline data"):
        toff.JsonReader(str(tmp_path / "none"))


def test_returns_to_go_matches_exactly(jx):
    from ray_tpu.rllib.algorithms.marwil import _returns_to_go
    rng = np.random.default_rng(4)
    b = {"rewards": rng.standard_normal(50),
         "terminateds": rng.random(50) < 0.1}
    for cols in (b, {"rewards": b["rewards"]}):
        ref = _returns_to_go(tsb.SampleBatch(cols), 0.97)
        out = tmarwil._returns_to_go(tsb.SampleBatch(cols), 0.97)
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)


def _jax_algo(cls, cfg_cls, data, **training):
    """A JAX offline algorithm without a cluster: config, data, learner."""
    algo = cls.__new__(cls)
    cfg = cfg_cls()
    cfg.env, cfg.env_config = "CartPole-v1", {"max_steps": 30}
    cfg.hidden, cfg.lr, cfg.seed = HIDDEN, LR, 0
    cfg.train_batch_size = BATCH
    for k, v in training.items():
        setattr(cfg, k, v)
    algo.algo_config = cfg
    algo.data = data
    algo.build_learner()
    return algo


def _read(tmp_path, frags):
    from ray_tpu.rllib import offline as joff
    _write(joff.JsonWriter, tmp_path, frags, 64 << 20)
    return str(tmp_path)


def test_bc_updates_match_jax(jx, tmp_path):
    from ray_tpu.rllib.algorithms.bc import BC, BCConfig
    path = _read(tmp_path, _fragments())
    data = toff.JsonReader(path, seed=0).read_all()
    j = _jax_algo(BC, BCConfig, data)
    t = tbc.BCLearner(4, 2, hidden=HIDDEN, lr=LR, seed=0, device="cpu")
    convert.load_jax(t.module, np_tree(j.params))
    rows = np.random.RandomState(0)
    for step in range(3):
        mj = j.training_step()
        batch = t.sample(data, BATCH)
        idx = rows.randint(0, len(data), size=BATCH)
        np.testing.assert_array_equal(batch["obs"], data["obs"][idx])
        np.testing.assert_array_equal(batch["actions"], data["actions"][idx])
        mt = t.update(batch)
        close(mt["loss"], mj["loss"], what=(step, "loss"))
    assert_adam_update_close(t, j.params, j.opt_state, LR, 3)
    out = tbc.evaluate(t.module, "CartPole-v1", {"max_steps": 30}, 0,
                       num_episodes=3)
    assert out == j.evaluate(num_episodes=3)


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_marwil_updates_match_jax(jx, tmp_path, beta):
    """Three updates carry adv_norm from 100.0; with beta 1 the weights
    reach the clip at 20."""
    from ray_tpu.rllib.algorithms.marwil import (MARWIL, MARWILConfig,
                                                 _returns_to_go)
    path = _read(tmp_path, _fragments())
    frags = []
    for frag in toff.JsonReader(path, seed=0).iter_batches():
        frag["returns"] = tmarwil._returns_to_go(frag, 0.99)
        np.testing.assert_array_equal(frag["returns"],
                                      _returns_to_go(frag, 0.99))
        frags.append(frag)
    data = tsb.concat_samples(frags)
    j = _jax_algo(MARWIL, MARWILConfig, data, beta=beta)
    j._rng = np.random.RandomState(0)
    t = tmarwil.MARWILLearner(4, 2, hidden=HIDDEN, lr=LR, beta=beta,
                              seed=0, device="cpu")
    convert.load_jax(t.module, np_tree(j.params))
    assert float(t.adv_norm) == float(j._adv_norm) == 100.0
    for step in range(3):
        mj = j.training_step()
        mt = t.update(t.sample(data, BATCH))
        for k in ("loss", "policy_loss", "vf_loss"):
            close(mt[k], mj[k], what=(step, k))
        close(float(t.adv_norm), float(j._adv_norm), what=(step, "norm"))
    assert_adam_update_close(t, j.params, j.opt_state, LR, 3)
    if beta:
        values = policy_value_apply(t.module, torch.from_numpy(
            data["obs"].astype(np.float32)))[1].detach().numpy()
        adv = data["returns"] - values
        assert np.exp(adv / np.sqrt(float(t.adv_norm))).max() > 20.0
