"""Model catalog: obs-space-driven network construction, the port of
``ray_tpu/rllib/catalog.py``.

Reference parity: rllib/models/catalog.py (ModelCatalog.get_model_v2 picks
a default fcnet / vision net / adds an LSTM wrapper from the model config
dict) and rllib/models/torch/{fcnet,visionnet,recurrent_net}.py:

  - flat observations  -> MLP torso (tanh, orthogonal init)
  - image observations -> CNN torso (relu, NHWC conv stack) + dense
  - use_lstm=True      -> an LSTM cell between torso and heads; sequence
    training loops the cell over time with carry resets at episode
    boundaries (done_prev).

The networks are ``nn.ModuleDict`` trees named as JAX's param trees
(``torso.layers.0.w``, ``torso.convs.1.w``, ``lstm.wx``, ``pi.0.b``), with
JAX's layouts: conv weights HWIO, dense ``[d_in, d_out]``. Three things are
JAX's and not torch's defaults, and each has one function here:

  - ``_conv_same``: XLA's SAME padding, whose odd pixel goes at the bottom
    and right (``Conv2d(padding="same")`` refuses stride > 1);
  - ``_flatten_nhwc``: the conv map is flattened in NHWC order, so the
    dense layer's rows mean what they mean in JAX;
  - ``_lstm_cell``: ``x @ wx + h @ wh + b`` split i, f, g, o, with +1.0 on
    the forget gate (``nn.LSTM`` has neither the +1 nor one bias).

Model config keys mirror the reference's (fcnet_hiddens, conv_filters,
use_lstm, lstm_cell_size, vf_share_layers).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib.models import Leaves, mlp_init


class ModelConfig:
    """Catalog knobs (subset of the reference MODEL_DEFAULTS that matters
    for the nets we build)."""

    def __init__(self,
                 fcnet_hiddens: Sequence[int] = (64, 64),
                 conv_filters: Optional[Sequence[Tuple[int, int, int]]] = None,
                 use_lstm: bool = False,
                 lstm_cell_size: int = 64,
                 vf_share_layers: bool = False):
        self.fcnet_hiddens = tuple(fcnet_hiddens)
        # [(out_channels, kernel, stride), ...]; None -> auto for the input.
        self.conv_filters = (None if conv_filters is None
                             else [tuple(f) for f in conv_filters])
        self.use_lstm = bool(use_lstm)
        self.lstm_cell_size = int(lstm_cell_size)
        self.vf_share_layers = bool(vf_share_layers)

    _KEYS = ("fcnet_hiddens", "conv_filters", "use_lstm",
             "lstm_cell_size", "vf_share_layers")

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "ModelConfig":
        d = dict(d or {})
        unknown = set(d) - set(ModelConfig._KEYS)
        if unknown:
            raise ValueError(
                f"unknown model config keys {sorted(unknown)}; "
                f"supported: {list(ModelConfig._KEYS)}")
        return ModelConfig(**d)

    def to_dict(self) -> Dict[str, Any]:
        return {"fcnet_hiddens": list(self.fcnet_hiddens),
                "conv_filters": self.conv_filters,
                "use_lstm": self.use_lstm,
                "lstm_cell_size": self.lstm_cell_size,
                "vf_share_layers": self.vf_share_layers}


def _default_conv_filters(obs_shape) -> List[Tuple[int, int, int]]:
    """Small-input defaults (the reference ships 84x84 Atari filters; our
    built-in image envs are small grids, so scale to the input)."""
    h = obs_shape[0]
    if h >= 32:
        return [(16, 8, 4), (32, 4, 2), (64, 3, 1)]
    if h >= 10:
        return [(16, 4, 2), (32, 3, 2)]
    return [(16, 3, 1), (32, 3, 1)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _conv_init(gen, in_ch: int, out_ch: int, kernel: int) -> Leaves:
    fan_in = kernel * kernel * in_ch
    w = torch.randn(kernel, kernel, in_ch, out_ch,
                    generator=gen) * math.sqrt(2.0 / fan_in)
    return Leaves(w=w, b=torch.zeros(out_ch))


def _normalize_obs_shape(obs_shape) -> Tuple[int, ...]:
    shape = tuple(int(s) for s in obs_shape)
    if len(shape) == 2:          # (H, W) grayscale -> (H, W, 1)
        shape = shape + (1,)
    return shape


def _torso_init(gen, obs_shape, cfg: ModelConfig):
    """-> (module, feature_dim). CNN for rank>=2 obs, MLP otherwise.

    The module holds only parameters; the static structure (mlp-vs-cnn,
    strides) is re-derived from (cfg, obs shape) at apply time, as in
    JAX."""
    shape = _normalize_obs_shape(obs_shape)
    if len(shape) == 1:
        sizes = [shape[0], *cfg.fcnet_hiddens]
        return (nn.ModuleDict({"layers": mlp_init(sizes, generator=gen,
                                                  device="cpu")}),
                sizes[-1])
    filters = cfg.conv_filters or _default_conv_filters(shape)
    h, w, ch = shape
    convs = nn.ModuleList()
    for out_ch, kernel, stride in filters:
        convs.append(_conv_init(gen, ch, out_ch, kernel))
        # SAME padding: ceil-div spatial reduction.
        h = -(-h // stride)
        w = -(-w // stride)
        ch = out_ch
    post = list(cfg.fcnet_hiddens) or [64]
    dense = mlp_init([h * w * ch, *post], generator=gen, device="cpu")
    return nn.ModuleDict({"convs": convs, "dense": dense}), post[-1]


def _lstm_init(gen, in_dim: int, cell: int) -> Leaves:
    return Leaves(
        wx=torch.randn(in_dim, 4 * cell, generator=gen)
        * math.sqrt(1.0 / in_dim),
        wh=torch.randn(cell, 4 * cell, generator=gen)
        * math.sqrt(1.0 / cell),
        b=torch.zeros(4 * cell))


def obs_shape_of(env) -> Tuple[int, ...]:
    """Canonical observation shape for catalog construction: the env's
    declared observation_shape, falling back to (observation_dim,).
    The ONE place this fallback lives — runners and learners must agree
    or they build different networks."""
    shape = tuple(getattr(env, "observation_shape", ()) or ())
    return shape or (int(env.observation_dim),)


def catalog_q_init(obs_shape, num_actions: int, cfg: ModelConfig, *,
                   generator: torch.Generator, device=None) -> nn.ModuleDict:
    """Q-network for the value-based family: torso + Q head only."""
    if cfg.use_lstm:
        raise ValueError("use_lstm is not supported for value-based "
                         "Q networks (R2D2 territory)")
    torso, feat = _torso_init(generator, obs_shape, cfg)
    net = nn.ModuleDict({
        "torso": torso,
        "pi": mlp_init([feat, num_actions], generator=generator,
                       device="cpu")})
    return net.to(resolve_device(device))


def catalog_init(obs_shape, num_outputs: int, cfg: ModelConfig, *,
                 generator: torch.Generator, device=None) -> nn.ModuleDict:
    """Build the policy/value network for an observation space.

    num_outputs is the pi-head width (action logits for PG-family, Q-values
    for the DQN family — the reference catalog makes the same dual use).
    """
    dev = resolve_device(device)
    torso, feat = _torso_init(generator, obs_shape, cfg)
    net = nn.ModuleDict({"torso": torso})
    head_in = feat
    if cfg.use_lstm:
        net["lstm"] = _lstm_init(generator, feat, cfg.lstm_cell_size)
        head_in = cfg.lstm_cell_size
    net["pi"] = mlp_init([head_in, num_outputs], generator=generator,
                         device="cpu")
    if cfg.vf_share_layers or cfg.use_lstm:
        # Recurrent nets share the torso+cell (reference recurrent_net.py
        # always shares); feed the value head from the same features.
        net["vf"] = mlp_init([head_in, 1], generator=generator,
                             device="cpu")
    else:
        vt, vfeat = _torso_init(generator, obs_shape, cfg)
        net["vf_torso"] = vt
        net["vf"] = mlp_init([vfeat, 1], generator=generator, device="cpu")
    return net.to(dev)


def catalog_rq_init(obs_shape, num_actions: int, cfg: ModelConfig, *,
                    generator: torch.Generator,
                    device=None) -> nn.ModuleDict:
    """Recurrent Q-network (R2D2 family): torso + LSTM + Q head, no
    value stream, no policy-logit scaling."""
    torso, feat = _torso_init(generator, obs_shape, cfg)
    net = nn.ModuleDict({
        "torso": torso,
        "lstm": _lstm_init(generator, feat, cfg.lstm_cell_size),
        "pi": mlp_init([cfg.lstm_cell_size, num_actions],
                       generator=generator, device="cpu")})
    return net.to(resolve_device(device))


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _mlp_apply(layers, x, final_act: bool = True):
    for i, layer in enumerate(layers):
        x = x @ layer.w + layer.b
        if final_act or i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def _conv_same(x, conv, stride: int):
    """XLA's ``conv_general_dilated(padding="SAME")`` on an NCHW map with
    an HWIO weight: each spatial dim padded to ceil(n / stride) outputs,
    the extra pixel of an odd padding at the bottom / right."""
    k = conv.w.shape[0]
    pads = []
    for n in (x.shape[3], x.shape[2]):           # F.pad lists W first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), conv.w.permute(3, 2, 0, 1), conv.b,
                    stride=stride)


def _flatten_nhwc(x):
    """[B, C, H, W] -> [B, H*W*C] in JAX's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _torso_apply(torso, obs, cfg: ModelConfig):
    if "layers" in torso:        # MLP
        return _mlp_apply(torso["layers"], obs)
    x = obs
    if x.dim() == 3:             # (B, H, W) -> (B, H, W, 1)
        x = x[..., None]
    filters = cfg.conv_filters or _default_conv_filters(x.shape[1:])
    x = x.permute(0, 3, 1, 2)    # NHWC -> NCHW
    for conv, (_oc, _k, stride) in zip(torso["convs"], filters):
        x = F.relu(_conv_same(x, conv, stride))
    return _mlp_apply(torso["dense"], _flatten_nhwc(x))


def _pi_head(params, feat):
    # 0.01 logit scale: near-uniform initial policy (matches the legacy
    # policy_value nets so learning curves are comparable).
    return _mlp_apply(params["pi"], feat, final_act=False) * 0.01


def _vf_head(params, feat):
    return _mlp_apply(params["vf"], feat, final_act=False)[..., 0]


def _heads(params, feat):
    return _pi_head(params, feat), _vf_head(params, feat)


def _q_head(params, h):
    return _mlp_apply(params["pi"], h, final_act=False)


def _lstm_cell(lstm, x, h, c):
    gates = x @ lstm.wx + h @ lstm.wh + lstm.b
    i, f, g, o = gates.chunk(4, dim=-1)
    # Forget-gate bias +1: standard recurrent-net stabilization.
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def initial_state(batch_size: int, cfg: ModelConfig, device=None):
    """Zero (h, c) carry for a recurrent model."""
    z = torch.zeros(batch_size, cfg.lstm_cell_size,
                    device=resolve_device(device))
    return (z, z)


def catalog_apply(params, obs, cfg: ModelConfig):
    """Stateless forward [B, ...] -> (logits [B, A], values [B])."""
    assert not cfg.use_lstm, "recurrent model: use catalog_apply_step/seq"
    feat = _torso_apply(params["torso"], obs, cfg)
    pi = _pi_head(params, feat)
    if "vf_torso" in params:
        vfeat = _torso_apply(params["vf_torso"], obs, cfg)
    else:
        vfeat = feat
    return pi, _vf_head(params, vfeat)


def catalog_q_apply(params, obs, cfg: ModelConfig):
    """Q-network forward for the value-based family: the pi head WITHOUT
    the 0.01 near-uniform-policy scale. -> Q [B, A]."""
    return _q_head(params, _torso_apply(params["torso"], obs, cfg))


def _recurrent_step(params, obs, state, cfg: ModelConfig):
    """Shared torso+LSTM step: [B, ...] + (h, c) -> (h', (h', c'))."""
    feat = _torso_apply(params["torso"], obs, cfg)
    h, c = _lstm_cell(params["lstm"], feat, *state)
    return h, (h, c)


def catalog_apply_step(params, obs, state, cfg: ModelConfig):
    """One recurrent step [B, ...] + (h, c) -> (logits, values, state')."""
    h, state = _recurrent_step(params, obs, state, cfg)
    pi, vf = _heads(params, h)
    return pi, vf, state


def catalog_rq_apply_step(params, obs, state, cfg: ModelConfig):
    """One recurrent Q step [B, ...] + (h, c) -> (q [B, A], state')."""
    h, state = _recurrent_step(params, obs, state, cfg)
    return _q_head(params, h), state


def _recurrent_scan(params, obs_seq, done_prev, state_in,
                    cfg: ModelConfig, head_fn):
    """Shared sequence loop over [B, T, ...]: a loop over time of the
    LSTM cell with the carry zeroed where done_prev marks an episode
    boundary; head_fn maps the hidden states [B, T, cell] to the output.
    The torso and the heads have no carry, so each runs once over all
    B*T steps. The ONE place the boundary machinery lives — the policy and
    Q families must not diverge."""
    b, t = obs_seq.shape[:2]
    flat = obs_seq.reshape(b * t, *obs_seq.shape[2:])
    feat = _torso_apply(params["torso"], flat, cfg).reshape(b, t, -1)
    h, c = state_in
    hs = []
    for step in range(t):
        mask = (1.0 - done_prev[:, step])[:, None]
        h, c = _lstm_cell(params["lstm"], feat[:, step], h * mask, c * mask)
        hs.append(h)
    return head_fn(params, torch.stack(hs, dim=1)), (h, c)


def catalog_rq_apply_seq(params, obs_seq, done_prev, state_in,
                         cfg: ModelConfig):
    """Recurrent Q over sequences: [B, T, ...] + done_prev [B, T] +
    (h, c) [B, cell] -> (q [B, T, A], state_out); carry resets at
    episode boundaries inside the loop."""
    return _recurrent_scan(params, obs_seq, done_prev, state_in, cfg,
                           _q_head)


def catalog_apply_seq(params, obs_seq, done_prev, state_in,
                      cfg: ModelConfig):
    """Sequence forward for BPTT training.

    obs_seq [B, T, ...], done_prev [B, T] (1.0 where step t-1 ended an
    episode — the carry resets there), state_in (h, c) each [B, cell]
    (the sampler's carry at fragment start). -> (logits [B, T, A],
    values [B, T], state_out).
    """
    (pi, vf), state_out = _recurrent_scan(
        params, obs_seq, done_prev, state_in, cfg, _heads)
    return pi, vf, state_out
