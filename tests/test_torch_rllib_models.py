"""Parity: ray_tpu_torch.rllib.{models,catalog,convert} and the noisy net
against their JAX counterparts in ray_tpu.rllib.

Each network starts from JAX's init (seed 0) moved in by
``rllib/convert.py``; inputs are numpy from a seed. Outputs within
VALUE_TOL and gradients within GRAD_TOL of each leaf's largest magnitude
(tests/torch_rllib_parity.py). The CNN runs at GridGoal sizes 5, 10 and 84,
which take the catalog's three default filter sets.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import catalog as tc
from ray_tpu_torch.rllib import convert
from ray_tpu_torch.rllib import models as tm
from ray_tpu_torch.rllib.algorithms import noisy as tnoisy
from torch_rllib_parity import (close, flat, grads_close, np_tree,
                                one_torch_thread)  # noqa: F401


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _obs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port(init_fn, tree):
    """A port network built by ``init_fn`` holding the JAX tree."""
    module = init_fn(generator=tm.seeded(1), device="cpu")
    convert.load_jax(module, tree)
    return module


def _jax_grads(fn, tree):
    import jax
    return flat(jax.grad(lambda p: fn(p).sum())(tree))


def _torch_grads(fn, module):
    module.zero_grad()
    fn(module).sum().backward()
    return {k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                else p.grad.numpy())
            for k, p in module.named_parameters()}


def _check(jax_fn, torch_fn, tree, module, n_out=1):
    """Outputs, and the gradients of a weighted sum of them, against JAX."""
    import jax.numpy as jnp
    j_out, t_out = jax_fn(tree), torch_fn(module)
    if n_out == 1:
        j_out, t_out = (j_out,), (t_out,)
    for a, b in zip(t_out, j_out):
        close(a.detach().numpy(), np.asarray(b))
    w = [_obs(np.shape(o), seed=7 + i) for i, o in enumerate(j_out)]
    jg = _jax_grads(lambda p: sum(
        (o * jnp.asarray(wi)).sum() for o, wi in zip(
            jax_fn(p) if n_out > 1 else (jax_fn(p),), w)), tree)
    tg = _torch_grads(lambda m: sum(
        (o * torch.from_numpy(wi)).sum() for o, wi in zip(
            torch_fn(m) if n_out > 1 else (torch_fn(m),), w)), module)
    assert sorted(jg) == sorted(tg)
    for k in jg:
        grads_close(tg[k], jg[k], k)


def test_mlp_and_policy_value_apply_match_jax(jx):
    from ray_tpu.rllib import models as jm
    tree = np_tree(jm.policy_value_init(jx.random.PRNGKey(0), 5, 3, (16, 8)))
    module = _port(lambda **kw: tm.policy_value_init(5, 3, (16, 8), **kw),
                   tree)
    assert sorted(module.state_dict()) == sorted(flat(tree))
    obs = _obs((6, 5))
    _check(lambda p: jm.policy_value_apply(p, obs),
           lambda m: tm.policy_value_apply(m, torch.from_numpy(obs)),
           tree, module, n_out=2)
    _check(lambda p: jm.mlp_apply(p["vf"], obs, final_scale=0.5),
           lambda m: tm.mlp_apply(m["vf"], torch.from_numpy(obs), 0.5),
           tree, module)


def test_sample_action_logp_is_log_softmax(jx):
    import jax
    logits = _obs((4000, 3)) * 2
    a, logp = tm.sample_action(tm.seeded(0), torch.from_numpy(logits))
    ref = np.asarray(jax.nn.log_softmax(logits))[np.arange(4000), a.numpy()]
    close(logp.numpy(), ref)
    # The draws follow the softmax: each action's share within 4 sigma.
    p = np.exp(np.asarray(jax.nn.log_softmax(logits)))
    counts = np.bincount(a.numpy(), minlength=3)
    assert np.all(np.abs(counts - p.sum(0)) < 4 * np.sqrt(p.sum(0)))


def test_continuous_heads_match_jax(jx):
    import jax
    from ray_tpu.rllib import models as jm
    key = jx.random.PRNGKey(0)
    obs, act = _obs((6, 3)), np.tanh(_obs((6, 2), seed=1))
    sg = np_tree(jm.squashed_gaussian_init(key, 3, 2, (16,)))
    m = _port(lambda **kw: tm.squashed_gaussian_init(3, 2, (16,), **kw), sg)
    _check(lambda p: jm.squashed_gaussian_apply(p, obs),
           lambda mod: tm.squashed_gaussian_apply(mod, torch.from_numpy(obs)),
           sg, m, n_out=2)
    # The sample with JAX's own normal draw passed in.
    rng = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(rng, (6, 2)))
    _check(lambda p: jm.squashed_gaussian_sample(rng, p, obs, -2.0, 2.0),
           lambda mod: tm.squashed_gaussian_sample(
               None, mod, torch.from_numpy(obs), -2.0, 2.0,
               eps=torch.from_numpy(eps)),
           sg, m, n_out=2)
    det = np_tree(jm.det_actor_init(key, 3, 2, (16,)))
    m = _port(lambda **kw: tm.det_actor_init(3, 2, (16,), **kw), det)
    _check(lambda p: jm.det_actor_apply(p, obs, -2.0, 2.0),
           lambda mod: tm.det_actor_apply(mod, torch.from_numpy(obs), -2.0,
                                          2.0), det, m)
    tq = np_tree(jm.twin_q_init(key, 3, 2, (16,)))
    m = _port(lambda **kw: tm.twin_q_init(3, 2, (16,), **kw), tq)
    _check(lambda p: jm.twin_q_apply(p, obs, act),
           lambda mod: tm.twin_q_apply(mod, torch.from_numpy(obs),
                                       torch.from_numpy(act)),
           tq, m, n_out=2)


def test_init_law_matches_jax(jx):
    """Same law, not the same numbers: orthogonal columns times sqrt(2),
    zero biases, conv and LSTM weights at JAX's scales."""
    net = tm.policy_value_init(4, 2, (64, 64), generator=tm.seeded(0),
                               device="cpu")
    w = net["pi"][1].w.detach().numpy()
    np.testing.assert_allclose(w.T @ w, 2.0 * np.eye(64), atol=1e-4)
    assert not net["pi"][1].b.detach().numpy().any()
    # Tall and wide corners: orthonormal columns, and rows.
    tall = net["pi"][0].w.detach().numpy()          # [4, 64]
    np.testing.assert_allclose(tall @ tall.T, 2.0 * np.eye(4), atol=1e-5)
    wide = tm.orthogonal(300, 20, tm.seeded(1)).numpy()
    np.testing.assert_allclose(wide.T @ wide, np.eye(20), atol=1e-5)
    # Haar: an entry of an orthogonal n x n matrix has variance 1/n.
    draws = np.stack([tm.orthogonal(8, 3, tm.seeded(i)).numpy()
                      for i in range(400)])
    assert abs(draws.var() - 1 / 8) < 0.01
    assert abs(draws.mean()) < 0.01
    cfg = tc.ModelConfig(fcnet_hiddens=(8,), use_lstm=True,
                         lstm_cell_size=256)
    cnn = tc.catalog_init((84, 84, 1), 4, cfg, generator=tm.seeded(0),
                          device="cpu")
    conv = cnn["torso"]["convs"][0].w.detach().numpy()
    assert conv.shape == (8, 8, 1, 16)
    assert abs(conv.std() - np.sqrt(2.0 / 64)) < 0.02
    wx = cnn["lstm"].wx.detach().numpy()
    assert wx.shape == (8, 1024) and abs(wx.std() - np.sqrt(1 / 8)) < 0.02


CNN_SIZES = [5, 10, 84]


@pytest.mark.parametrize("size", CNN_SIZES)
def test_cnn_torso_matches_jax(jx, size):
    """The catalog's default filters for a GridGoal of this size (three
    sets: SAME padding with stride 1, 2 and 4, odd and even maps), the
    NHWC flatten into the dense layer, both heads and their gradients.

    At 84 the weights go the other way, the port's init (the same law)
    into JAX's tree: JAX's init draws each dense layer from a Haar matrix
    of side fan_in = 7744, and two such QRs take about 25 s alone here and
    ran past the test's 180 s limit under the suite's load."""
    from ray_tpu.rllib import catalog as jc
    from ray_tpu_torch.models.convert import unflatten
    cfg = {"fcnet_hiddens": [16]}
    jcfg, tcfg = jc.ModelConfig.from_dict(cfg), tc.ModelConfig.from_dict(cfg)
    shape = (size, size, 1)
    if size == 84:
        module = tc.catalog_init(shape, 4, tcfg, generator=tm.seeded(0),
                                 device="cpu")
        tree = unflatten({k: v.numpy().copy()
                          for k, v in module.state_dict().items()})
    else:
        tree = np_tree(jc.catalog_init(jx.random.PRNGKey(0), shape, 4,
                                       jcfg))
        module = _port(lambda **kw: tc.catalog_init(shape, 4, tcfg, **kw),
                       tree)
    assert len(module["torso"]["convs"]) == len(
        jc._default_conv_filters(shape))
    obs = np.abs(_obs((3, size, size, 1)))
    _check(lambda p: jc.catalog_apply(p, obs, jcfg),
           lambda m: tc.catalog_apply(m, torch.from_numpy(obs), tcfg),
           tree, module, n_out=2)
    # A (B, H, W) observation gains its channel, as in JAX.
    close(tc.catalog_apply(module, torch.from_numpy(obs[..., 0]),
                           tcfg)[0].detach().numpy(),
          np.asarray(jc.catalog_apply(tree, obs[..., 0], jcfg)[0]))


def test_cnn_flatten_order_matters(jx):
    """The control of chip_smoke's CNN gate: flattening the conv map in
    NCHW order gives other features than JAX's, so the same weights
    disagree."""
    from ray_tpu.rllib import catalog as jc
    cfg = {"fcnet_hiddens": [16]}
    jcfg, tcfg = jc.ModelConfig.from_dict(cfg), tc.ModelConfig.from_dict(cfg)
    tree = np_tree(jc.catalog_init(jx.random.PRNGKey(0), (10, 10, 1), 4,
                                   jcfg))
    module = _port(lambda **kw: tc.catalog_init((10, 10, 1), 4, tcfg, **kw),
                   tree)
    obs = torch.from_numpy(np.abs(_obs((3, 10, 10, 1))))
    nhwc = tc._flatten_nhwc
    with torch.no_grad():
        good = tc.catalog_apply(module, obs, tcfg)[1]
        try:
            tc._flatten_nhwc = lambda x: x.reshape(x.shape[0], -1)
            bad = tc.catalog_apply(module, obs, tcfg)[1]
        finally:
            tc._flatten_nhwc = nhwc
    assert float((good - bad).abs().max()) > 100 * 2e-5


@pytest.mark.parametrize("cfg", [{"fcnet_hiddens": [16, 8]},
                                 {"fcnet_hiddens": [16],
                                  "vf_share_layers": True}])
def test_mlp_torso_and_q_heads_match_jax(jx, cfg):
    from ray_tpu.rllib import catalog as jc
    jcfg, tcfg = jc.ModelConfig.from_dict(cfg), tc.ModelConfig.from_dict(cfg)
    key = jx.random.PRNGKey(0)
    obs = _obs((5, 3))
    tree = np_tree(jc.catalog_init(key, (3,), 2, jcfg))
    module = _port(lambda **kw: tc.catalog_init((3,), 2, tcfg, **kw), tree)
    assert ("vf_torso" in module) == (not tcfg.vf_share_layers)
    _check(lambda p: jc.catalog_apply(p, obs, jcfg),
           lambda m: tc.catalog_apply(m, torch.from_numpy(obs), tcfg),
           tree, module, n_out=2)
    qtree = np_tree(jc.catalog_q_init(key, (3,), 2, jcfg))
    qmod = _port(lambda **kw: tc.catalog_q_init((3,), 2, tcfg, **kw), qtree)
    assert sorted(qmod.state_dict()) == sorted(flat(qtree))
    _check(lambda p: jc.catalog_q_apply(p, obs, jcfg),
           lambda m: tc.catalog_q_apply(m, torch.from_numpy(obs), tcfg),
           qtree, qmod)


def _lstm_setup(jx, obs_shape=(3,), cell=8, q=False):
    from ray_tpu.rllib import catalog as jc
    cfg = {"fcnet_hiddens": [8], "use_lstm": True, "lstm_cell_size": cell}
    jcfg, tcfg = jc.ModelConfig.from_dict(cfg), tc.ModelConfig.from_dict(cfg)
    if q:
        tree = np_tree(jc.catalog_rq_init(jx.random.PRNGKey(0), obs_shape, 2,
                                          jcfg))
        module = _port(lambda **kw: tc.catalog_rq_init(obs_shape, 2, tcfg,
                                                       **kw), tree)
    else:
        tree = np_tree(jc.catalog_init(jx.random.PRNGKey(0), obs_shape, 2,
                                       jcfg))
        module = _port(lambda **kw: tc.catalog_init(obs_shape, 2, tcfg, **kw),
                       tree)
    return jc, jcfg, tcfg, tree, module


def _sequence(b=3, t=7, obs_shape=(3,), cell=8):
    obs = _obs((b, t, *obs_shape))
    done_prev = np.zeros((b, t), np.float32)
    done_prev[0, 3] = 1.0      # env 0's episode ended at t=2
    done_prev[2, 1] = done_prev[2, 5] = 1.0
    h = _obs((b, cell), seed=3) * 0.5
    c = _obs((b, cell), seed=4) * 0.5
    return obs, done_prev, h, c


@pytest.mark.parametrize("q", [False, True], ids=["policy", "q"])
def test_lstm_sequence_with_resets_matches_jax(jx, q):
    """catalog_apply_seq / catalog_rq_apply_seq against JAX's lax.scan, with
    carries reset mid-sequence, a nonzero carry in, the carry out, and the
    gradients through the whole sequence."""
    jc, jcfg, tcfg, tree, module = _lstm_setup(jx, q=q)
    obs, done_prev, h, c = _sequence()
    tt = [torch.from_numpy(a) for a in (obs, done_prev, h, c)]
    if q:
        jfn = lambda p: (lambda o: (o[0], *o[1]))(  # noqa: E731
            jc.catalog_rq_apply_seq(p, obs, done_prev, (h, c), jcfg))
        tfn = lambda m: (lambda o: (o[0], *o[1]))(  # noqa: E731
            tc.catalog_rq_apply_seq(m, tt[0], tt[1], (tt[2], tt[3]), tcfg))
    else:
        jfn = lambda p: (lambda o: (o[0], o[1], *o[2]))(  # noqa: E731
            jc.catalog_apply_seq(p, obs, done_prev, (h, c), jcfg))
        tfn = lambda m: (lambda o: (o[0], o[1], *o[2]))(  # noqa: E731
            tc.catalog_apply_seq(m, tt[0], tt[1], (tt[2], tt[3]), tcfg))
    _check(jfn, tfn, tree, module, n_out=3 if q else 4)


@pytest.mark.parametrize("q", [False, True], ids=["policy", "q"])
def test_lstm_step_matches_jax(jx, q):
    jc, jcfg, tcfg, tree, module = _lstm_setup(jx, q=q)
    obs, _, h, c = _sequence()
    o = obs[:, 0]
    if q:
        jfn = lambda p: (lambda r: (r[0], *r[1]))(  # noqa: E731
            jc.catalog_rq_apply_step(p, o, (h, c), jcfg))
        tfn = lambda m: (lambda r: (r[0], *r[1]))(  # noqa: E731
            tc.catalog_rq_apply_step(m, torch.from_numpy(o),
                                     (torch.from_numpy(h),
                                      torch.from_numpy(c)), tcfg))
    else:
        jfn = lambda p: (lambda r: (r[0], r[1], *r[2]))(  # noqa: E731
            jc.catalog_apply_step(p, o, (h, c), jcfg))
        tfn = lambda m: (lambda r: (r[0], r[1], *r[2]))(  # noqa: E731
            tc.catalog_apply_step(m, torch.from_numpy(o),
                                  (torch.from_numpy(h),
                                   torch.from_numpy(c)), tcfg))
    _check(jfn, tfn, tree, module, n_out=3 if q else 4)


def test_lstm_without_forget_bias_disagrees(jx):
    """The control of chip_smoke's LSTM gate: the cell without the +1 on
    the forget gate is another function of the same weights."""
    _jc, _jcfg, tcfg, _tree, module = _lstm_setup(jx)
    obs, done_prev, h, c = (torch.from_numpy(a) for a in _sequence())
    with torch.no_grad():
        good = tc.catalog_apply_seq(module, obs, done_prev, (h, c), tcfg)[1]
    cell = tc._lstm_cell

    def no_bias(lstm, x, h, c):
        gates = x @ lstm.wx + h @ lstm.wh + lstm.b
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c
    try:
        tc._lstm_cell = no_bias
        with torch.no_grad():
            bad = tc.catalog_apply_seq(module, obs, done_prev, (h, c),
                                       tcfg)[1]
    finally:
        tc._lstm_cell = cell
    assert float((good - bad).abs().max()) > 100 * 2e-5


# The port's form of tests/test_rllib_catalog.py:22, :36 and :49.

def test_catalog_builds_cnn_for_image_obs():
    cfg = tc.ModelConfig.from_dict({"fcnet_hiddens": [32]})
    params = tc.catalog_init((5, 5, 1), 4, cfg, generator=tm.seeded(0),
                             device="cpu")
    assert "convs" in params["torso"]
    obs = torch.rand(7, 5, 5, 1)
    logits, values = tc.catalog_apply(params, obs, cfg)
    assert logits.shape == (7, 4)
    assert values.shape == (7,)


def test_catalog_builds_mlp_for_flat_obs():
    cfg = tc.ModelConfig.from_dict({"fcnet_hiddens": [16, 16]})
    params = tc.catalog_init((3,), 2, cfg, generator=tm.seeded(0),
                             device="cpu")
    assert "layers" in params["torso"]
    logits, values = tc.catalog_apply(params, torch.rand(5, 3), cfg)
    assert logits.shape == (5, 2)
    assert values.shape == (5,)


def test_lstm_seq_apply_matches_stepwise():
    """catalog_apply_seq must equal step-by-step catalog_apply_step,
    including a mid-sequence episode-boundary carry reset."""
    cfg = tc.ModelConfig.from_dict({"fcnet_hiddens": [8], "use_lstm": True,
                                    "lstm_cell_size": 8})
    params = tc.catalog_init((3,), 2, cfg, generator=tm.seeded(0),
                             device="cpu")
    b, t = 2, 6
    obs = torch.from_numpy(_obs((b, t, 3)))
    done_prev = torch.zeros(b, t)
    done_prev[0, 3] = 1.0
    state = tc.initial_state(b, cfg, device="cpu")
    with torch.no_grad():
        seq_logits, seq_values, _ = tc.catalog_apply_seq(
            params, obs, done_prev, state, cfg)
        h, c = state
        for step in range(t):
            mask = (1.0 - done_prev[:, step])[:, None]
            lg, vl, (h, c) = tc.catalog_apply_step(
                params, obs[:, step], (h * mask, c * mask), cfg)
            close(lg.numpy(), seq_logits[:, step].numpy(), tol=1e-6)
            close(vl.numpy(), seq_values[:, step].numpy(), tol=1e-6)


def test_model_config_rejects_unknown_keys_and_lstm_q():
    with pytest.raises(ValueError, match="unknown model config keys"):
        tc.ModelConfig.from_dict({"fcnet_hidden": [8]})
    with pytest.raises(ValueError, match="use_lstm is not supported"):
        tc.catalog_q_init((3,), 2, tc.ModelConfig(use_lstm=True),
                          generator=tm.seeded(0), device="cpu")
    assert tc.ModelConfig.from_dict(
        tc.ModelConfig(conv_filters=[(4, 3, 1)]).to_dict()).conv_filters \
        == [(4, 3, 1)]


@pytest.mark.parametrize("kind", ["cnn", "lstm"])
def test_ravel_matches_ravel_pytree(jx, kind):
    """convert.ravel is jax.flatten_util.ravel_pytree's vector (sorted dict
    keys, lists in order: layers 10 and 11 after 9), and unravel inverts
    it."""
    from jax.flatten_util import ravel_pytree
    from ray_tpu.rllib import catalog as jc
    if kind == "cnn":
        cfg = {"fcnet_hiddens": [4] * 12}
        shape = (10, 10, 1)
    else:
        cfg = {"fcnet_hiddens": [6], "use_lstm": True, "lstm_cell_size": 4}
        shape = (3,)
    jcfg, tcfg = jc.ModelConfig.from_dict(cfg), tc.ModelConfig.from_dict(cfg)
    tree = np_tree(jc.catalog_init(jx.random.PRNGKey(0), shape, 2, jcfg))
    module = _port(lambda **kw: tc.catalog_init(shape, 2, tcfg, **kw), tree)
    ref = np.asarray(ravel_pytree(tree)[0])
    vec = convert.ravel(module)
    np.testing.assert_array_equal(vec, ref)
    back = convert.unravel(module, vec * 2)
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy() * 2)
    with pytest.raises(ValueError, match="flat vector"):
        convert.unravel(module, vec[:-1])


@pytest.mark.parametrize("double_layer", [False, True])
def test_noisy_net_apply_with_jax_noise_matches_jax(jx, double_layer):
    """noisy_net_apply with the factorized noise JAX draws from a key (the
    same splits as ray_tpu's noisy_net_apply), and the mu-only net."""
    import jax
    from ray_tpu.rllib.algorithms import noisy as jn
    sizes = [4, 16, 16, 2] if double_layer else [4, 8, 2]
    tree = np_tree(jn.noisy_net_init(0, sizes, 0.5))
    module = tnoisy.noisy_net_init(1, sizes, 0.5, device="cpu")
    convert.load_jax(module, {"q": tree})
    key = jax.random.PRNGKey(5)
    noise = jax_noise(tree, key)
    obs = _obs((6, 4))
    _check(lambda p: jn.noisy_net_apply(p["q"], obs, key),
           lambda m: tnoisy.noisy_net_apply(m["q"], torch.from_numpy(obs),
                                            noise),
           {"q": tree}, module)
    close(tnoisy.noisy_net_apply(module["q"], torch.from_numpy(obs),
                                 None).detach().numpy(),
          np.asarray(jn.noisy_net_apply(tree, obs, None)))
    # The port's own draws: f(e) = sign(e) sqrt|e| of standard normals.
    draws = tnoisy.noisy_net_noise(module["q"], tm.seeded(0))
    assert [(a.shape[0], b.shape[0]) for a, b in draws] == list(
        zip(sizes[:-1], sizes[1:]))
    e = torch.cat([torch.cat(d) for d in draws])
    assert torch.all(torch.sign(e) * e * e <= 6.0)


def jax_noise(layers, key):
    """The noise ray_tpu's noisy_net_apply draws from ``key``, as the port's
    [(f(eps_in), f(eps_out)), ...] (torch tensors)."""
    import jax
    import jax.numpy as jnp
    out = []
    for layer in layers:
        key, k1, k2 = jax.random.split(key, 3)
        fi, fo = np.shape(layer["mu_w"])
        e_in, e_out = (jax.random.normal(k, (n,)) for k, n in
                       ((k1, fi), (k2, fo)))
        out.append(tuple(torch.from_numpy(np.array(
            jnp.sign(e) * jnp.sqrt(jnp.abs(e)))) for e in (e_in, e_out)))
    return out
