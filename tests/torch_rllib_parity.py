"""Shared checks of the RLlib parity tests (``tests/test_torch_rllib_*.py``).

Both packages run in one CPU process; the port's networks start from the
JAX init, moved in by ``ray_tpu_torch.rllib.convert``. Bounds are fp32, as
in ``tests/test_parallel.py::TestAttention``: values within VALUE_TOL
(absolute, and relative for values above 1), gradients and Adam's moments
within GRAD_TOL of the leaf's largest magnitude.

Parameters after Adam steps are held to VALUE_TOL. One exception, from
Adam itself: the update m / (sqrt(v) + eps) turns a gradient that is
rounding noise (below NEAR_ZERO = 10 eps) into a step of up to lr, with a
sign the two frameworks need not share. An element whose first moment is
that small but not 0 in either framework after the update may therefore
differ by up to 2 lr per step taken; elements beyond VALUE_TOL must be
such elements, and fewer than 0.1% of the network's.
"""

import numpy as np
import pytest
import torch

VALUE_TOL = 2e-5
GRAD_TOL = 2e-4
ADAM_B1 = 0.9
NEAR_ZERO = 1e-7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The nets here are tiny: one intra-op thread is as fast, and leaves
    the cores to the suite's other workers. Imported by each test module
    (an autouse fixture applies where it is imported)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree):
    """{dotted path: numpy} of a JAX tree (the port's parameter names)."""
    from ray_tpu_torch.models.convert import flatten
    return {k: np.asarray(v) for k, v in flatten(np_tree(tree)).items()}


def close(a, b, tol=VALUE_TOL, what=""):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=str(what))


def grads_close(a, b, what=""):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(1e-12, float(np.abs(b).max(initial=0.0)))
    err = float(np.abs(a - b).max(initial=0.0))
    assert err <= GRAD_TOL * scale, (what, err, scale)


def torch_grads(module):
    return {k: p.grad.detach().cpu().numpy()
            for k, p in module.named_parameters()}


def adam_moments(learner):
    """{name: (exp_avg, exp_avg_sq)} of a port learner's Adam; zeros for a
    parameter no loss reached (torch keeps no state for it, optax keeps
    zeros)."""
    state = learner.optimizer.state
    out = {}
    for k, p in learner.module.named_parameters():
        st = state.get(p)
        out[k] = ((st["exp_avg"].cpu().numpy(),
                   st["exp_avg_sq"].cpu().numpy()) if st else
                  (np.zeros(tuple(p.shape), np.float32),) * 2)
    return out


def assert_adam_update_close(learner, jax_params, jax_opt_state, lr,
                             steps):
    """The port learner's parameters and Adam moments after ``steps`` Adam
    steps against the JAX learner's (module doc)."""
    adam = jax_opt_state[0]
    mu, nu = flat(adam.mu), flat(adam.nu)
    ref = flat(jax_params)
    moments = adam_moments(learner)
    n_off = n_total = 0
    small = (1 - ADAM_B1) * NEAR_ZERO
    for name, p in learner.module.named_parameters():
        m, v = moments[name]
        grads_close(m, mu[name], ("exp_avg", name))
        grads_close(v, nu[name], ("exp_avg_sq", name))
        loose = (((m != 0) & (np.abs(m) < small))
                 | ((mu[name] != 0) & (np.abs(mu[name]) < small)))
        err = np.abs(p.detach().cpu().numpy() - ref[name])
        assert err[~loose].max(initial=0.0) <= VALUE_TOL, (name, err.max())
        assert err[loose].max(initial=0.0) <= 2 * lr * steps, name
        n_off += int((err > VALUE_TOL).sum())
        n_total += err.size
    assert n_off < 1e-3 * n_total, (n_off, n_total)


def batches_equal(a, b, float_keys=()):
    """Two SampleBatches: the same keys; float_keys within VALUE_TOL, every
    other column identical."""
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for k in a:
        if k in float_keys:
            close(a[k], b[k], what=k)
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
