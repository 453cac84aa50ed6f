"""DQN: the port of ``ray_tpu/rllib/algorithms/dqn.py`` (``DQNConfig`` :28,
``nstep_transform`` :71, ``DQNLearner`` :118, ``CatalogQRunner`` :214,
``DuelingDQNRunner`` :235, ``DQN`` :256).

Reference parity: rllib/algorithms/dqn/dqn.py (training_step: sample ->
store -> replay -> TD update -> target sync, with a target network and
double-Q bootstrapping) with optional prioritized replay
(rllib/utils/replay_buffers/prioritized_replay_buffer.py). Exploration is
epsilon-greedy with linear decay.

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
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.catalog import (ModelConfig, catalog_q_apply,
                                         catalog_q_init, obs_shape_of)
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import Learner, to_tensor
from ray_tpu_torch.rllib.models import (mlp_apply, policy_value_init,
                                        seeded)
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)
from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_samples


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DQN)
        self.rollout_fragment_length = 32
        self.n_step = 1
        self.replay_buffer_capacity = 50_000
        self.learning_starts = 500
        self.target_network_update_freq = 500   # in sampled env steps
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_steps = 5_000
        self.double_q = True
        self.dueling = False
        self.prioritized_replay = False
        self.train_batch_size = 64
        self.updates_per_step = 4

    def training(self, *, replay_buffer_capacity=None, learning_starts=None,
                 target_network_update_freq=None, epsilon_start=None,
                 epsilon_end=None, epsilon_decay_steps=None, double_q=None,
                 prioritized_replay=None, updates_per_step=None,
                 n_step=None, dueling=None, **kw) -> "DQNConfig":
        super().training(**kw)
        for name, val in (("n_step", n_step),
                          ("dueling", dueling),
                          ("replay_buffer_capacity", replay_buffer_capacity),
                          ("learning_starts", learning_starts),
                          ("target_network_update_freq",
                           target_network_update_freq),
                          ("epsilon_start", epsilon_start),
                          ("epsilon_end", epsilon_end),
                          ("epsilon_decay_steps", epsilon_decay_steps),
                          ("double_q", double_q),
                          ("prioritized_replay", prioritized_replay),
                          ("updates_per_step", updates_per_step)):
            if val is not None:
                setattr(self, name, val)
        return self


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

    def get_target_weights(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone()
                for k, v in self.target.state_dict().items()}

    def set_target_weights(self, weights) -> None:
        self.target.load_state_dict(weights)

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


class DQN(Algorithm):
    config_class = DQNConfig
    # Catalog model configs (CNN Q-nets) supported by DQN/APEX; the
    # distributional/noisy variants build their own heads and opt out.
    supports_model_config = True

    def _validate_config(self):
        super()._validate_config()
        cfg = self.algo_config
        # Catalog-combo checks only apply where the catalog is in play
        # (opted-out variants route model=None and keep the legacy net).
        if cfg.model is not None and self.supports_model_config:
            if cfg.dueling:
                raise ValueError("dueling=True cannot combine with a "
                                 "catalog model config")
            if ModelConfig.from_dict(cfg.model).use_lstm:
                raise ValueError("use_lstm is not supported for "
                                 "value-based Q networks (R2D2 "
                                 "territory)")

    def _runner_class(self):
        if self.algo_config.model is not None:
            return CatalogQRunner
        return (DuelingDQNRunner if self.algo_config.dueling
                else EnvRunner)

    def _make_q_learner(self, probe):
        """Q-learner factory; the distributional variant (C51) overrides
        just this instead of copying build_learner."""
        cfg = self.algo_config
        return DQNLearner(
            probe.observation_dim, probe.num_actions, hidden=cfg.hidden,
            lr=cfg.lr, gamma=cfg.gamma, double_q=cfg.double_q,
            dueling=cfg.dueling, seed=cfg.seed,
            obs_shape=obs_shape_of(probe), model=cfg.model,
            device=cfg.device)

    def _make_replay(self, capacity: int):
        cfg = self.algo_config
        buf_cls = (PrioritizedReplayBuffer if cfg.prioritized_replay
                   else ReplayBuffer)
        return buf_cls(capacity, seed=cfg.seed)

    def build_learner(self):
        cfg = self.algo_config
        probe = make_env(cfg.env, cfg.env_config)
        self.learner = self._make_q_learner(probe)
        self.replay = self._make_replay(cfg.replay_buffer_capacity)
        self._steps_sampled = 0
        self._last_target_sync = 0
        self.broadcast_weights(self.learner.get_weights())

    def _epsilon(self) -> float:
        cfg = self.algo_config
        frac = min(1.0, self._steps_sampled / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end
                                           - cfg.epsilon_start)

    def _replay_updates(self) -> float:
        """``updates_per_step`` updates from the replay buffer (PER's
        priorities moved after each), the new weights to the runners;
        -> the mean loss."""
        cfg = self.algo_config
        losses = []
        for _ in range(cfg.updates_per_step):
            replayed = self.replay.sample(cfg.train_batch_size)
            m = self.learner.update(replayed)
            if cfg.prioritized_replay and "batch_indexes" in replayed:
                self.replay.update_priorities(
                    replayed["batch_indexes"], m["td_error"] + 1e-6)
            losses.append(m["loss"])
        self.broadcast_weights(self.learner.get_weights())
        return float(np.mean(losses))

    def _maybe_sync_target(self):
        cfg = self.algo_config
        if (self._steps_sampled - self._last_target_sync
                >= cfg.target_network_update_freq):
            self.learner.sync_target()
            self._last_target_sync = self._steps_sampled

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        eps = self._epsilon()
        batches = self._rt.get(
            [er.sample_transitions.remote(cfg.rollout_fragment_length, eps)
             for er in self.env_runners])
        if cfg.n_step > 1:
            # Per-runner (each runner's batch has its own env interleave).
            batches = [nstep_transform(b, cfg.n_step, cfg.gamma,
                                       cfg.num_envs_per_env_runner)
                       for b in batches]
        batch = concat_samples(batches)
        self.replay.add(batch)
        self._steps_sampled += len(batch)
        metrics: Dict[str, Any] = {"epsilon": eps,
                                   "replay_size": len(self.replay),
                                   "num_env_steps_sampled": len(batch)}
        if len(self.replay) >= cfg.learning_starts:
            metrics["loss"] = self._replay_updates()
        self._maybe_sync_target()
        return metrics

    def save_checkpoint(self):
        return {"params": self.learner.get_weights(),
                "target": self.learner.get_target_weights(),
                "steps": self._steps_sampled,
                "iteration": self._iteration}

    def load_checkpoint(self, ckpt):
        self.learner.set_weights(ckpt["params"])
        self.learner.set_target_weights(ckpt["target"])
        self._steps_sampled = ckpt.get("steps", 0)
        self._iteration = ckpt.get("iteration", 0)
        self.broadcast_weights(self.learner.get_weights())
