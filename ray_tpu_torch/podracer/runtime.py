"""The podracer members: the port of ``ray_tpu/podracer/runtime.py``
(``_to_numpy_tree`` :70, ``_RolloutWorker`` :75, ``_Learner`` :139).

A tick of the substrate (JAX's module docstring): the host loop sends
(tick, weight_version, weights) to every rollout member, each returns a
fixed-shape fragment, and the learner takes every member's fragment,
updates, and stamps a new weight version. The members here are the port's
``EnvRunner`` and ``PPOLearner`` on a device (None -> the card); the
weights travel between them as JAX's do, a numpy tree in the JAX layout
(``pi.0.w`` -> ``{"pi": [{"w": ...}]}``), folded from the learner's state
dict once per broadcast. ``PodracerRun`` and the compiled-DAG runtime
hold no JAX and are not copied: a caller composes collect -> learn ->
broadcast, or binds these classes into ``ray_tpu``'s DAG as
``PodracerRun._build`` does.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List

import numpy as np
import torch

from ray_tpu_torch.models.convert import params_from_jax, unflatten
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import PPOLearner


def _to_numpy_tree(weights: Dict[str, torch.Tensor]):
    """A state dict -> the JAX-layout tree of numpy arrays, copied (the
    tree outlives the learner's next step, as JAX's immutable arrays do)."""
    return unflatten({k: v.detach().cpu().numpy().copy()
                      for k, v in weights.items()})


class _RolloutWorker:
    """One actor-gang member: wraps an rllib EnvRunner; `collect` is the
    compiled-DAG node method (fixed-shape fragments per tick)."""

    # The columns a PPO learner consumes — everything else the sampler
    # produces stays host-local so the channel message shape is fixed
    # and minimal.
    _COLS = ("obs", "actions", "action_logp", "advantages",
             "value_targets")

    def __init__(self, env_spec, env_config: dict, num_envs: int,
                 fragment_len: int, seed: int, hidden=(32, 32),
                 gamma: float = 0.99, lam: float = 0.95, device=None):
        self._runner = EnvRunner(env_spec, env_config, num_envs, seed,
                                 hidden=tuple(hidden), device=device)
        self._fragment_len = int(fragment_len)
        self._gamma = float(gamma)
        self._lam = float(lam)
        self._version = 0
        # Bounded: one entry per collect on a loop that ticks forever.
        self._versions_seen: deque = deque(maxlen=4096)

    def collect(self, ctl) -> dict:
        """One rollout fragment under the weights `ctl` announces.
        ctl = (tick, weight_version, weights), weights a JAX-layout numpy
        tree, loaded only when the version advanced. (JAX's runtime may
        send a plane ref in place of an oversize tree; its host loop is not
        ported, and a caller here sends the tree.)"""
        tick, version, weights = ctl
        if weights is not None and version > self._version:
            # Copied out of the ring slot / store view once per broadcast
            # (params_from_jax copies each leaf).
            self._runner.set_weights(params_from_jax(weights))
            self._version = version
        self._versions_seen.append(self._version)
        batch = self._runner.sample(self._fragment_len, self._gamma,
                                    self._lam)
        return {
            "tick": tick,
            "version": self._version,
            "ctl_version": version,
            "steps": self._fragment_len * len(self._runner._envs),
            "rewards": self._runner.episode_rewards(),
            "columns": {k: np.asarray(batch[k]) for k in self._COLS},
        }

    def versions_seen(self) -> List[int]:
        """Recent weight versions at each collect, in order (must be
        monotonic — non-decreasing)."""
        return list(self._versions_seen)

    def ping(self):
        return True


class _Learner:
    """The learner gang's single rep: consumes every gang's batch each
    tick, runs the PPO update, and stamps a new weight version on a
    cadence, with the weights folded to numpy once per broadcast."""

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float,
                 hidden=(32, 32), minibatch_size: int = 64,
                 num_epochs: int = 1, broadcast_interval: int = 1,
                 seed: int = 0, device=None):
        self._learner = PPOLearner(obs_dim, num_actions, lr=lr,
                                   hidden=tuple(hidden), seed=seed,
                                   device=device)
        self._minibatch_size = int(minibatch_size)
        self._num_epochs = int(num_epochs)
        self._broadcast_interval = max(1, int(broadcast_interval))
        self._seed = seed
        self._version = 0
        self._weights = None
        self._applied = 0
        self._broadcast()

    def _broadcast(self):
        """Stamp a new version; the numpy param tree rides the output to
        the host loop, which folds it into the next control tuple."""
        self._version += 1
        self._weights = _to_numpy_tree(self._learner.module.state_dict())

    def control(self) -> tuple:
        """(version, weights) for the first control tuple."""
        return (self._version, self._weights)

    def learn(self, *batches) -> dict:
        # Restart resumption: a restarted learner holds fresh params, but
        # the control echo names the live version sequence — resume it so
        # versions observed downstream stay monotonic.
        ctl_version = max(b["ctl_version"] for b in batches)
        if ctl_version > self._version:
            self._version = ctl_version
            self._weights = _to_numpy_tree(self._learner.module.state_dict())
        cols = {k: np.concatenate([b["columns"][k] for b in batches])
                for k in batches[0]["columns"]}
        train = sb.SampleBatch(cols)
        metrics = self._learner.update(
            train, minibatch_size=min(self._minibatch_size,
                                      len(train)) or 1,
            num_epochs=self._num_epochs,
            seed=self._seed + self._applied)
        self._applied += 1
        broadcast = self._applied % self._broadcast_interval == 0
        if broadcast:
            self._broadcast()
        tick = batches[0]["tick"]
        return {
            "tick": tick,
            # Exactly-once probe: applied must equal tick+1 at every
            # collected output.
            "applied": self._applied,
            "tick_skew": sum(1 for b in batches if b["tick"] != tick),
            "version": self._version,
            # Params ride the output only when the version bumped.
            "weights": self._weights if broadcast else None,
            # Per-actor weight versions at sample time, in actor order.
            "versions": [b["version"] for b in batches],
            "staleness": self._version - min(b["version"] for b in batches),
            "num_batches": len(batches),
            "steps": int(sum(b["steps"] for b in batches)),
            "rewards": [r for b in batches for r in b["rewards"]],
            "metrics": {k: float(v) for k, v in metrics.items()},
        }

    def ping(self):
        return True
