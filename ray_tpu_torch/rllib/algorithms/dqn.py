"""DQN's compute: the port of ``ray_tpu/rllib/algorithms/dqn.py``
(``nstep_transform`` :71, ``DQNLearner`` :118, ``CatalogQRunner`` :214,
``DuelingDQNRunner`` :235).

Reference parity: rllib/algorithms/dqn/dqn.py (TD update with a target
network and double-Q bootstrapping). The algorithm's training loop (``DQN``,
a ``tune.Trainable``: sample -> store -> replay -> update -> target sync)
is orchestration and is not ported: a caller composes a runner, a
``ReplayBuffer`` and a learner the way its ``training_step`` does.

``QLearner`` is the update the value-based learners share (DQN, C51,
QR-DQN, Noisy DQN, R2D2): one Adam step on a replayed batch, the target
network a ``copy.deepcopy`` of the module without gradients, and
``{"td_error": per-sample priorities, "loss": float}`` back.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.catalog import (ModelConfig, catalog_q_apply,
                                         catalog_q_init, obs_shape_of)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import Learner, to_tensor
from ray_tpu_torch.rllib.models import (mlp_apply, policy_value_init,
                                        seeded)
from ray_tpu_torch.rllib.sample_batch import SampleBatch

NSTEP_GAMMAS = "nstep_gammas"


def nstep_transform(batch: SampleBatch, n: int, gamma: float,
                    num_envs: int) -> SampleBatch:
    """Collapse 1-step transitions into n-step ones (reference:
    rllib/utils/replay_buffers/utils.py n-step logic).

    sample_transitions interleaves env copies per timestep
    ([t0e0, t0e1, t1e0, ...]); each env's stream is de-interleaved,
    rewards are accumulated sum_{k<m} gamma^k r_{t+k} with the window
    cut at terminations and the fragment tail, next_obs comes from the
    window's last step, and a per-sample bootstrap discount gamma^m is
    recorded (windows truncated by episode end or fragment end have
    m < n, so a scalar gamma^n would be wrong).
    """
    if n <= 1:
        return batch
    size = len(batch)
    t_steps = size // num_envs
    out = {k: [] for k in (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.NEXT_OBS,
                           sb.TERMINATEDS, NSTEP_GAMMAS)}
    trunc_all = batch.get(sb.TRUNCATEDS,
                          np.zeros(size, dtype=bool))
    for e in range(num_envs):
        idx = np.arange(t_steps) * num_envs + e
        rew = batch[sb.REWARDS][idx]
        term = batch[sb.TERMINATEDS][idx]
        trunc = trunc_all[idx]
        for t in range(t_steps):
            r_acc, m = 0.0, 0
            for k in range(n):
                if t + k >= t_steps:
                    break
                r_acc += (gamma ** k) * float(rew[t + k])
                m = k + 1
                # The env resets after term OR trunc: the window must not
                # bridge into the next episode's stream.
                if term[t + k] or trunc[t + k]:
                    break
            last = idx[t + m - 1]
            out[sb.OBS].append(batch[sb.OBS][idx[t]])
            out[sb.ACTIONS].append(batch[sb.ACTIONS][idx[t]])
            out[sb.REWARDS].append(r_acc)
            out[sb.NEXT_OBS].append(batch[sb.NEXT_OBS][last])
            out[sb.TERMINATEDS].append(batch[sb.TERMINATEDS][last])
            out[NSTEP_GAMMAS].append(gamma ** m)
    return SampleBatch({k: np.asarray(v) for k, v in out.items()})


def taken(values, actions):
    """values[rows, actions] over the leading axes: [..., A] -> [...]."""
    return values.gather(-1, actions[..., None])[..., 0]


class QLearner(Learner):
    """One Adam step of ``_loss`` per replayed batch, and the target net.

    ``_loss(cols)`` returns (loss, per-sample priority); ``cols`` holds the
    batch's ``_COLUMNS`` on the device, the per-sample bootstrap discount
    (``nstep_gammas``, default gamma) and the importance ``weights``
    (default 1)."""

    _COLUMNS = (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.NEXT_OBS, sb.TERMINATEDS)

    def __init__(self, module, lr: float, gamma: float, device):
        super().__init__(module, lr, device)
        self._gamma = gamma
        self.sync_target()

    def sync_target(self):
        self.target = copy.deepcopy(self.module).requires_grad_(False)

    def _columns(self, batch) -> Dict[str, torch.Tensor]:
        cols = {k: to_tensor(batch[k], self.device) for k in self._COLUMNS}
        n = len(batch)
        cols[NSTEP_GAMMAS] = (
            to_tensor(batch[NSTEP_GAMMAS], self.device)
            if NSTEP_GAMMAS in batch else
            torch.full((n,), self._gamma, device=self.device))
        cols["weights"] = (to_tensor(batch["weights"], self.device)
                           if "weights" in batch else
                           torch.ones(n, device=self.device))
        return cols

    def update(self, batch: SampleBatch, **loss_kw) -> Dict[str, Any]:
        loss, per_sample = self._loss(self._columns(batch), **loss_kw)
        self._step(loss)
        return {"td_error": per_sample.detach().cpu().numpy(),
                "loss": float(loss.detach())}


class DQNLearner(QLearner):
    def __init__(self, obs_dim: int, num_actions: int, *, hidden=(64, 64),
                 lr=5e-4, gamma=0.99, double_q=True, dueling=False,
                 obs_shape=None, model=None, seed=0, device=None):
        device = resolve_device(device)
        gen = seeded(seed)
        self._double_q = double_q
        if model is not None:
            # Catalog Q-net (CNN torso for image observations).
            mcfg = ModelConfig.from_dict(model)
            shape = tuple(obs_shape) if obs_shape else (obs_dim,)
            module = catalog_q_init(shape, num_actions, mcfg,
                                    generator=gen, device=device)
            self._q = lambda p, obs: catalog_q_apply(p, obs, mcfg)
        else:
            module = policy_value_init(obs_dim, num_actions, tuple(hidden),
                                       generator=gen, device=device)
            self._q = dueling_q if dueling else plain_q
        super().__init__(module, lr, gamma, device)

    def _loss(self, c):
        q_taken = taken(self._q(self.module, c[sb.OBS]), c[sb.ACTIONS])
        with torch.no_grad():
            q_next_target = self._q(self.target, c[sb.NEXT_OBS])
            if self._double_q:
                # Action chosen by the ONLINE net, valued by the target net.
                a_next = self._q(self.module, c[sb.NEXT_OBS]).argmax(-1)
                v_next = taken(q_next_target, a_next)
            else:
                v_next = q_next_target.max(-1).values
            not_done = 1.0 - c[sb.TERMINATEDS].float()
            # Per-sample bootstrap discount: gamma for 1-step, gamma^m
            # for n-step windows (m < n at episode/fragment cuts).
            target = c[sb.REWARDS] + c[NSTEP_GAMMAS] * not_done * v_next
        td = q_taken - target
        return (c["weights"] * td * td).mean(), td.abs()


def plain_q(p, obs):
    """Q head = the "pi" MLP without the small-logits scaling."""
    return mlp_apply(p["pi"], obs)


def dueling_q(p, obs):
    """Dueling (Wang et al. 2016; reference model config dueling=True): the
    "vf" stream is the state value and "pi" the advantage stream, combined
    with the mean-advantage identifiability constraint."""
    adv = mlp_apply(p["pi"], obs)
    return mlp_apply(p["vf"], obs) + adv - adv.mean(-1, keepdim=True)


def _greedy(q_fn):
    """A runner forward from a Q function: (scores, max score)."""
    def fwd(p, obs):
        q = q_fn(p, obs)
        return q, q.max(-1).values
    return fwd


class CatalogQRunner(EnvRunner):
    """EnvRunner whose greedy scores come from the catalog Q-net (CNN
    torso for image observations) — matches DQNLearner's model path."""

    def _build_policy(self, seed, hidden, model):
        e0 = self._envs[0]
        mcfg = ModelConfig.from_dict(model)
        self.module = catalog_q_init(obs_shape_of(e0), e0.num_actions,
                                     mcfg, generator=seeded(seed),
                                     device=self.device)
        self._forward = _greedy(lambda p, obs: catalog_q_apply(p, obs, mcfg))


class DuelingDQNRunner(EnvRunner):
    """EnvRunner whose greedy scores combine the value + advantage
    streams exactly as the dueling learner's q_values does."""

    def _build_policy(self, seed, hidden, model):
        e0 = self._envs[0]
        self.module = policy_value_init(
            e0.observation_dim, e0.num_actions, tuple(hidden),
            generator=seeded(seed), device=self.device)
        self._forward = _greedy(dueling_q)
