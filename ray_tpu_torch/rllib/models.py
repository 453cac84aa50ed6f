"""Policy/value networks as torch modules: the port of
``ray_tpu/rllib/models.py``.

A network is an ``nn.Module`` whose ``state_dict`` names are the JAX param
tree's paths joined by dots (``pi.0.w``, ``vf.2.b``, ``net.1.w``): a list of
layers is an ``nn.ModuleList``, a dict an ``nn.ModuleDict`` and a leaf dict
a ``Leaves``, so ``rllib/convert.py`` moves JAX trees in and out without
renaming or transposing. Weights keep JAX's ``[d_in, d_out]`` layout and a
dense layer is ``x @ w + b``, as in JAX.

Each ``*_init`` draws its weights from an explicit CPU ``torch.Generator``
with JAX's init law (orthogonal times sqrt(2), zero biases), so the numbers
do not depend on the device, then moves them to ``device`` (None -> the
card, through ``resolve_device``). Each ``*_apply`` is JAX's, taking the
module where JAX takes the param tree.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch import resolve_device


class Leaves(nn.Module):
    """One leaf dict of a JAX param tree: each keyword is a parameter."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, value in tensors.items():
            setattr(self, name, nn.Parameter(value))


def orthogonal(fan_in: int, fan_out: int,
               generator: torch.Generator) -> torch.Tensor:
    """The [fan_in, fan_out] corner of a Haar-random orthogonal matrix of
    side max(fan_in, fan_out), JAX's ``orthogonal(n)[:fan_in, :fan_out]``.
    The same law, drawn cheaper: a Haar matrix's first k columns are
    uniform on the Stiefel manifold, which is the Q of a normal [n, k]
    matrix's reduced QR with its columns' signs set by R's diagonal (and
    its first k rows are such a Q transposed). At 84x84 observations the
    CNN's dense layer has fan_in 7744: a [7744, 64] QR, not [7744, 7744]."""
    n, k = max(fan_in, fan_out), min(fan_in, fan_out)
    q, r = torch.linalg.qr(torch.randn(n, k, generator=generator))
    q = q * torch.sign(torch.diagonal(r))
    return q if fan_in >= fan_out else q.T


def dense_init(fan_in: int, fan_out: int, generator: torch.Generator,
               scale: float = math.sqrt(2.0)) -> Leaves:
    w = orthogonal(fan_in, fan_out, generator)
    return Leaves(w=(w * scale).contiguous(), b=torch.zeros(fan_out))


def mlp_init(sizes: Sequence[int], *, generator: torch.Generator,
             device=None) -> nn.ModuleList:
    layers = nn.ModuleList(dense_init(i, o, generator)
                           for i, o in zip(sizes[:-1], sizes[1:]))
    return layers.to(resolve_device(device))


def mlp_apply(layers, x, final_scale: float = 1.0):
    h = x
    for i, layer in enumerate(layers):
        h = h @ layer.w + layer.b
        if i < len(layers) - 1:
            h = torch.tanh(h)
    return h * final_scale


def policy_value_init(obs_dim: int, num_actions: int,
                      hidden: Tuple[int, ...] = (64, 64), *,
                      generator: torch.Generator,
                      device=None) -> nn.ModuleDict:
    """Separate policy and value MLPs (rllib default fcnet)."""
    return nn.ModuleDict({
        "pi": mlp_init([obs_dim, *hidden, num_actions], generator=generator,
                       device=device),
        "vf": mlp_init([obs_dim, *hidden, 1], generator=generator,
                       device=device),
    })


def policy_value_apply(params, obs):
    """-> (logits, value)."""
    logits = mlp_apply(params["pi"], obs, final_scale=0.01)
    value = mlp_apply(params["vf"], obs)[..., 0]
    return logits, value


def sample_action(generator: torch.Generator, logits):
    """Categorical sample + log-prob."""
    a = torch.multinomial(torch.softmax(logits, -1), 1,
                          generator=generator)[:, 0]
    logp = F.log_softmax(logits, -1).gather(-1, a[:, None])[:, 0]
    return a, logp


# ---- continuous control (SAC family) -----------------------------------

def squashed_gaussian_init(obs_dim: int, action_dim: int,
                           hidden: Tuple[int, ...] = (64, 64), *,
                           generator: torch.Generator,
                           device=None) -> nn.ModuleDict:
    """Actor emitting (mean, log_std) for a tanh-squashed Gaussian
    (reference: rllib/models catalog's SquashedGaussian distribution)."""
    return nn.ModuleDict({"net": mlp_init(
        [obs_dim, *hidden, 2 * action_dim], generator=generator,
        device=device)})


def squashed_gaussian_apply(params, obs):
    """-> (mean, log_std), log_std clipped to a sane range."""
    mean, log_std = mlp_apply(params["net"], obs).chunk(2, dim=-1)
    return mean, log_std.clamp(-20.0, 2.0)


def tanh_slope(x):
    """1 - tanh(x)^2, as sech(x)^2 = 4 e^{-2|x|} / (1 + e^{-2|x|})^2.

    JAX writes ``1 - tanh(x) ** 2``, which cancels in fp32: past |x| of
    about 4 the difference is below tanh's rounding, so its ``log(. +
    1e-6)`` carries an error up to 0.4, and a last-bit difference between
    two tanh implementations (XLA's and torch's, or the card's and the
    CPU's) moves it by as much (ROADMAP queue 3, R-5). This form has no
    cancellation: it is the same function, accurate to a few ulps."""
    z = torch.exp(-2.0 * x.abs())
    return 4.0 * z / (1.0 + z) ** 2


def squashed_gaussian_sample(generator, params, obs, low: float,
                             high: float, eps=None):
    """Reparameterized sample -> (action in [low, high], log_prob). The
    standard normal ``eps`` (shaped like the mean) is drawn from
    ``generator`` unless given."""
    mean, log_std = squashed_gaussian_apply(params, obs)
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator,
                          device=mean.device)
    pre = mean + log_std.exp() * eps
    tanh = torch.tanh(pre)
    # log N(pre) - log |d tanh/d pre|, summed over action dims.
    logp = (-0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
            - torch.log(tanh_slope(pre) + 1e-6)).sum(-1)
    scale = (high - low) / 2.0
    mid = (high + low) / 2.0
    return mid + scale * tanh, logp


def det_actor_init(obs_dim: int, action_dim: int,
                   hidden: Tuple[int, ...] = (64, 64), *,
                   generator: torch.Generator,
                   device=None) -> nn.ModuleDict:
    """Deterministic policy mu(s) for DDPG/TD3 (reference:
    rllib/algorithms/ddpg deterministic actor)."""
    return nn.ModuleDict({"net": mlp_init(
        [obs_dim, *hidden, action_dim], generator=generator,
        device=device)})


def det_actor_apply(params, obs, low: float, high: float):
    """tanh-bounded deterministic action in [low, high]."""
    scale = (high - low) / 2.0
    mid = (high + low) / 2.0
    return mid + scale * torch.tanh(mlp_apply(params["net"], obs))


def twin_q_init(obs_dim: int, action_dim: int,
                hidden: Tuple[int, ...] = (64, 64), *,
                generator: torch.Generator,
                device=None) -> nn.ModuleDict:
    """Two independent Q(s, a) critics (clipped double-Q)."""
    sizes = [obs_dim + action_dim, *hidden, 1]
    return nn.ModuleDict({
        "q1": mlp_init(sizes, generator=generator, device=device),
        "q2": mlp_init(sizes, generator=generator, device=device)})


def twin_q_apply(params, obs, action):
    x = torch.cat([obs, action], dim=-1)
    return (mlp_apply(params["q1"], x)[..., 0],
            mlp_apply(params["q2"], x)[..., 0])


def seeded(seed: int, device=None) -> torch.Generator:
    """A generator seeded as JAX seeds ``PRNGKey(seed)``; on the CPU unless
    ``device`` is given (init draws stay on the CPU)."""
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(int(seed))
    return gen

