"""Shared parts of the algorithm parity tests
(``tests/test_torch_rllib_algorithms*.py``).

Each case builds the JAX algorithm from its config (its runners are
``ray_tpu`` actors of the module's cluster) and the port's from the same
config in process on the CPU, moves JAX's ``save_checkpoint()`` into the
port's ``load_checkpoint`` (``rllib/convert.py``), and trains both for the
same number of iterations. Bounds are ``tests/torch_rllib_parity.py``'s.
"""

import contextlib

import numpy as np
import pytest

from ray_tpu_torch.rllib import convert
from torch_rllib_parity import close, flat, np_tree

HIDDEN = [16, 16]
# Metrics that are counts or host bookkeeping: equal, not close.
EXACT = ("num_env_steps_sampled", "num_agent_steps_sampled",
         "episodes_total", "episode_reward_mean", "training_iteration",
         "replay_size", "replay_sequences", "buffer_size", "epsilon",
         "num_minibatch_updates", "num_samples_trained",
         "num_env_steps_sampled_lifetime")


@pytest.fixture(scope="module")
def cluster(jax_cpu):
    """One ray_tpu cluster for the module's JAX algorithms."""
    import ray_tpu
    ray_tpu.init(num_cpus=4, num_tpus=0)
    yield ray_tpu
    ray_tpu.shutdown()


def small(cfg, runners=2, fragment=32):
    """The tests' size: the legacy MLP at hidden 16x16, ``runners``
    runners of one env, ``fragment`` steps a fragment, seed 0."""
    cfg.hidden = tuple(HIDDEN)
    return (cfg.env_runners(num_env_runners=runners,
                            rollout_fragment_length=fragment)
            .debugging(seed=0))


def port_checkpoint(ckpt, multi_agent=False):
    """A JAX algorithm's checkpoint as the port's: every tree of
    parameters (``params``, ``target``, ``state``; one per policy for a
    multi-agent one) through ``convert.params_from_jax``."""
    out = dict(ckpt)
    for key in ("params", "target", "state"):
        if key in ckpt:
            tree = np_tree(ckpt[key])
            out[key] = ({pid: convert.params_from_jax(t)
                         for pid, t in tree.items()} if multi_agent
                        else convert.params_from_jax(tree))
    if "adv_norm" in ckpt:
        out["adv_norm"] = float(np.asarray(ckpt["adv_norm"]))
    return out


@contextlib.contextmanager
def pair(jcfg, tcfg, prepare=None, multi_agent=False):
    """(JAX algorithm, port algorithm), the port's loaded from the JAX
    one's checkpoint (``prepare`` may edit it first; JAX loads the edited
    one too). The port loads it as soon as its learner is built, before
    anything samples (IMPALA primes its rollouts in ``setup``). Both are
    stopped on exit."""
    j = jcfg.build()
    t = None
    try:
        ckpt = j.save_checkpoint()
        if prepare is not None:
            ckpt = prepare(ckpt)
            j.load_checkpoint(ckpt)
        ported = port_checkpoint(ckpt, multi_agent)

        class FromJax(tcfg.algo_class):
            def build_learner(self):
                super().build_learner()
                self.load_checkpoint(ported)

        tcfg.algo_class = FromJax
        t = tcfg.resources(device="cpu").build()
        yield j, t
    finally:
        j.stop()
        if t is not None:
            t.stop()


def train_both(j, t, iters=2):
    rj, rt = [], []
    for _ in range(iters):
        rj.append(j.train())
        rt.append(t.train())
    return rj, rt


def results_match(rj, rt, skip=()):
    """Per iteration: the same metric keys; the counts, episode returns
    and epsilon equal; every other number within VALUE_TOL. The values of
    the keys in ``skip`` (those that depend on a device draw) are not
    compared."""
    for it, (a, b) in enumerate(zip(rj, rt)):
        assert sorted(a) == sorted(b), (it, sorted(a), sorted(b))
        for k in a:
            if k in skip:
                continue
            if k in EXACT:
                np.testing.assert_equal(b[k], a[k], err_msg=f"{it} {k}")
            else:
                close(b[k], a[k], what=(it, k))


def weights_match(tmodule, jtree, what=""):
    """A port module's state dict against a JAX tree, within VALUE_TOL."""
    ref = flat(jtree)
    state = tmodule.state_dict()
    assert sorted(state) == sorted(ref), what
    for k, v in state.items():
        close(v.detach().cpu().numpy(), ref[k], what=(what, k))


def counting(obj, name):
    """Wrap ``obj.name`` to count its calls; -> the list of call counts
    (one entry per call)."""
    calls = []
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    setattr(obj, name, wrapped)
    return calls
