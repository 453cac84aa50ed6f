"""PPO learner: the port of ``ray_tpu/rllib/learner.py``.

Reference parity: rllib/core/learner/learner.py:106. A learner holds an
``nn.Module`` and ``torch.optim.Adam(lr, eps=1e-8)``, which is optax's
``adam(lr)`` (b1 0.9, b2 0.999, eps outside the square root, both moments
bias-corrected). An update moves the batch's columns to the learner's
device once, then takes each minibatch there by the indices that
``sample_batch.minibatch_indices`` draws, the order of JAX's
``SampleBatch.minibatches``; the metrics are summed on the device and read
back once per update.

With a `model` config the learner builds through the catalog: CNN torsos
for image observations and, with use_lstm, sequence training — fragments
become [B, T] sequences, the LSTM replays the sampler's exact carries
(state_in columns) with carry resets at episode boundaries, and
minibatching permutes whole sequences.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.catalog import (ModelConfig, catalog_apply,
                                         catalog_apply_seq, catalog_init)
from ray_tpu_torch.rllib.models import (policy_value_apply,
                                        policy_value_init, seeded)

ADAM_EPS = 1e-8    # optax.adam's default


def to_tensor(arr, device) -> torch.Tensor:
    """A batch column on ``device``: floats as float32 (JAX's default
    precision), booleans as they are, integers as int64 indices."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32, copy=False)
    elif arr.dtype.kind in "iu":
        arr = arr.astype(np.int64, copy=False)
    return torch.as_tensor(arr, device=device)


class Learner:
    """A module with optax's adam over its parameters, and the weights'
    hand-off: ``get_weights`` returns a state dict (a snapshot, as JAX's
    arrays are immutable) that a module on any device loads with
    ``set_weights``."""

    def __init__(self, module: nn.Module, lr: float, device: torch.device):
        self.device = device
        self.module = module
        self.optimizer = torch.optim.Adam(module.parameters(), lr=lr,
                                          eps=ADAM_EPS)

    def _step(self, loss: torch.Tensor) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone()
                for k, v in self.module.state_dict().items()}

    def set_weights(self, weights) -> None:
        self.module.load_state_dict(weights)


class PPOLearner(Learner):
    _METRICS = ("policy_loss", "vf_loss", "entropy", "kl", "total_loss")

    def __init__(self, obs_dim: int, num_actions: int, *,
                 hidden=(64, 64), lr=5e-4, clip_param=0.2,
                 vf_coeff=0.5, entropy_coeff=0.0, seed=0,
                 obs_shape: Optional[Tuple[int, ...]] = None,
                 model: Optional[Dict[str, Any]] = None,
                 seq_len: Optional[int] = None, device=None):
        device = resolve_device(device)
        gen = seeded(seed)
        self._clip_param = clip_param
        self._vf_coeff = vf_coeff
        self._entropy_coeff = entropy_coeff
        self._seq_len = None
        if model is not None:
            mcfg = ModelConfig.from_dict(model)
            shape = tuple(obs_shape) if obs_shape else (obs_dim,)
            module = catalog_init(shape, num_actions, mcfg, generator=gen,
                                  device=device)
            if mcfg.use_lstm:
                if not seq_len:
                    raise ValueError("recurrent model needs seq_len "
                                     "(= rollout_fragment_length)")
                self._seq_len = seq_len
                self._forward = lambda m, b: catalog_apply_seq(
                    m, b[sb.OBS], b[sb.DONE_PREV],
                    (b[sb.STATE_IN_H], b[sb.STATE_IN_C]), mcfg)[:2]
            else:
                self._forward = lambda m, b: catalog_apply(m, b[sb.OBS],
                                                           mcfg)
        else:
            module = policy_value_init(obs_dim, num_actions,
                                       tuple(hidden), generator=gen,
                                       device=device)
            self._forward = lambda m, b: policy_value_apply(m, b[sb.OBS])
        super().__init__(module, lr, device)

    def _loss(self, mb):
        """PPO loss math over the minibatch's flattened steps."""
        logits, values = self._forward(self.module, mb)
        logits = logits.reshape(-1, logits.shape[-1])
        values = values.reshape(-1)
        actions, old_logp, adv, vtarg = (
            mb[k].reshape(-1) for k in (sb.ACTIONS, sb.LOGPS,
                                        sb.ADVANTAGES, sb.VALUE_TARGETS))
        logp_all = F.log_softmax(logits, -1)
        logp = logp_all.gather(-1, actions[:, None])[:, 0]
        # jnp.std's ddof is 0.
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg_loss = self._pg_loss(logp, old_logp, adv)
        vf_loss = ((values - vtarg) ** 2).mean()
        entropy = -(logp_all.exp() * logp_all).sum(-1).mean()
        total = (pg_loss + self._vf_coeff * vf_loss
                 - self._entropy_coeff * entropy)
        return total, (pg_loss, vf_loss, entropy,
                       (old_logp - logp).mean(), total)

    def _pg_loss(self, logp, old_logp, adv):
        """Clipped-surrogate policy gradient (overridden by A2C with the
        vanilla advantage gradient)."""
        ratio = torch.exp(logp - old_logp)
        pg1 = ratio * adv
        pg2 = ratio.clamp(1 - self._clip_param, 1 + self._clip_param) * adv
        return -torch.minimum(pg1, pg2).mean()

    def _columns(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's columns on the device, one row per step or, for a
        recurrent model, one row per [T] sequence with the sampler's carry
        at the sequence's first step as its state_in."""
        cols = (sb.OBS, sb.ACTIONS, sb.LOGPS, sb.ADVANTAGES,
                sb.VALUE_TARGETS)
        t = self._seq_len
        if t is None:
            return {k: to_tensor(batch[k], self.device) for k in cols}
        n = len(batch)
        if n % t:
            raise ValueError(f"batch of {n} not divisible by seq_len {t}")
        rows = n // t
        out = {}
        for k in cols + (sb.DONE_PREV,):
            arr = np.asarray(batch[k])
            out[k] = to_tensor(arr.reshape(rows, t, *arr.shape[1:]),
                               self.device)
        for k in (sb.STATE_IN_H, sb.STATE_IN_C):
            out[k] = to_tensor(
                np.asarray(batch[k]).reshape(rows, t, -1)[:, 0], self.device)
        return out

    def update(self, batch, *, minibatch_size: int, num_epochs: int,
               seed=0) -> Dict[str, float]:
        cols = self._columns(batch)
        rows = len(cols[sb.OBS])
        per_mb = (minibatch_size if self._seq_len is None
                  else max(1, minibatch_size // self._seq_len))
        sels = list(sb.minibatch_indices(rows, per_mb, num_epochs, seed))
        metrics: Dict[str, float] = {}
        if sels:
            order = torch.as_tensor(np.stack(sels), device=self.device)
            sums = 0.0
            for sel in order:
                loss, terms = self._loss({k: v[sel]
                                          for k, v in cols.items()})
                self._step(loss)
                sums = sums + torch.stack(terms).detach()
            metrics = dict(zip(self._METRICS,
                               (sums.double() / len(sels)).tolist()))
        metrics["num_minibatch_updates"] = len(sels)
        return metrics
