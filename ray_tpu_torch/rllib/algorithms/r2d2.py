"""R2D2: the port of ``ray_tpu/rllib/algorithms/r2d2.py`` (``R2D2Config``
:34, ``R2D2Runner`` :61, ``R2D2Learner`` :156, ``R2D2`` :251).

Reference parity: rllib/algorithms/r2d2 (Kapturowski et al. 2019):

  - runners collect fixed-length SEQUENCES with the sampler's LSTM carry
    at the fragment start (the stored-state strategy; zero-state only at
    true episode starts);
  - the replay buffer holds whole sequences (one row each);
  - the learner replays each sequence through the catalog's recurrent
    loop (carry resets at in-sequence episode boundaries), computes
    double-Q TD targets from the WITHIN-sequence next step (q[t+1]); the
    final step of each sequence has no successor and is masked from the
    loss; an optional burn-in prefix rebuilds the carry without
    contributing loss.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithms.dqn import (DQN, DQNConfig, QLearner,
                                                taken)
from ray_tpu_torch.rllib.catalog import (ModelConfig, catalog_rq_apply_seq,
                                         catalog_rq_apply_step,
                                         catalog_rq_init, obs_shape_of)
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.env_runner import EnvRunner, with_weights
from ray_tpu_torch.rllib.models import seeded
from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_samples


class R2D2Config(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or R2D2)
        self.rollout_fragment_length = 16   # = training sequence length
        self.lstm_cell_size = 32
        self.burn_in = 0                    # carry-rebuild prefix steps
        self.train_batch_size = 16          # sequences per update

    def training(self, *, lstm_cell_size=None, burn_in=None,
                 **kw) -> "R2D2Config":
        super().training(**kw)
        if lstm_cell_size is not None:
            self.lstm_cell_size = lstm_cell_size
        if burn_in is not None:
            self.burn_in = burn_in
        return self


def _mcfg(cfg_hidden, lstm_cell_size, model):
    d = dict(model or {})
    d.setdefault("fcnet_hiddens", list(cfg_hidden))
    d["use_lstm"] = True
    d["lstm_cell_size"] = lstm_cell_size
    return ModelConfig.from_dict(d)


class R2D2Runner(EnvRunner):
    """Collects [n_envs, T] sequences with per-step stored carries and
    epsilon-greedy actions over the recurrent Q net."""

    def __init__(self, *args, lstm_cell_size=32, **kw):
        self._cell = lstm_cell_size
        super().__init__(*args, **kw)

    def _build_policy(self, seed, hidden, model):
        e0 = self._envs[0]
        mcfg = self._mcfg = _mcfg(hidden, self._cell, model)
        self.module = catalog_rq_init(obs_shape_of(e0), e0.num_actions, mcfg,
                                      generator=seeded(seed),
                                      device=self.device)
        z = np.zeros((len(self._envs), self._cell), np.float32)
        self._state = [z, z.copy()]
        self._step_fn = lambda p, o, s: catalog_rq_apply_step(p, o, s, mcfg)
        self._done_prev = np.zeros(len(self._envs), np.float32)

    def evaluate_return(self, weights, episodes: int = 1,
                        max_steps: int = 500) -> float:
        """Greedy recurrent evaluation (the base class's shapes don't
        fit the (q, state) step signature)."""
        module = with_weights(self.module, weights)
        env = make_env(self._env_spec, self._env_config)
        total = 0.0
        for _ep in range(episodes):
            obs, _ = env.reset(seed=int(self._rng.randint(2 ** 31)))
            z = np.zeros((1, self._cell), np.float32)
            state = (z, z)
            for _ in range(max_steps):
                x = self._obs_conn(np.asarray(obs)[None], update=False)
                q, state = self._step(x, state, module)
                obs, r, term, trunc, _ = env.step(int(np.argmax(q[0])))
                total += r
                if term or trunc:
                    break
        return total / episodes

    def sample_sequences(self, num_steps: int,
                         epsilon: float) -> SampleBatch:
        """One fragment per env: columns shaped [n_envs, T, ...] plus the
        fragment-start carry [n_envs, cell] and per-step done flags."""
        cols: Dict[str, List] = {k: [] for k in (
            sb.OBS, sb.ACTIONS, sb.REWARDS, "dones", sb.TERMINATEDS,
            sb.DONE_PREV)}
        h0, c0 = self._state[0].copy(), self._state[1].copy()
        for _t in range(num_steps):
            obs_arr = self._obs_conn(np.stack(self._obs))
            q, (h2, c2) = self._step(obs_arr, tuple(self._state))
            step = {k: [] for k in cols}
            for i, env in enumerate(self._envs):
                if self._rng.rand() < epsilon:
                    a = self._rng.randint(q.shape[-1])
                else:
                    a = int(np.argmax(q[i]))
                obs2, r, term, trunc, _ = env.step(a)
                step[sb.OBS].append(obs_arr[i])
                step[sb.ACTIONS].append(a)
                step[sb.REWARDS].append(r)
                step["dones"].append(float(term or trunc))
                step[sb.TERMINATEDS].append(float(term))
                step[sb.DONE_PREV].append(self._done_prev[i])
                self._ep_rewards[i] += r
                self._done_prev[i] = 0.0
                if term or trunc:
                    self._done_rewards.append(self._ep_rewards[i])
                    self._ep_rewards[i] = 0.0
                    obs2, _ = env.reset()
                    h2[i] = 0.0
                    c2[i] = 0.0
                    self._done_prev[i] = 1.0
                self._obs[i] = obs2
            for k, v in step.items():
                cols[k].append(v)
            self._state = [h2, c2]
        # [T, n_envs, ...] -> [n_envs, T, ...]
        out = {k: np.swapaxes(np.asarray(v), 0, 1)
               for k, v in cols.items()}
        out[sb.STATE_IN_H] = h0
        out[sb.STATE_IN_C] = c0
        return SampleBatch(out)


class R2D2Learner(QLearner):
    _COLUMNS = (sb.OBS, sb.ACTIONS, sb.REWARDS, "dones", sb.TERMINATEDS,
                sb.DONE_PREV, sb.STATE_IN_H, sb.STATE_IN_C)

    def __init__(self, obs_shape, num_actions: int, *, hidden=(64, 64),
                 lstm_cell_size=32, lr=5e-4, gamma=0.99, double_q=True,
                 burn_in=0, model=None, seed=0, device=None):
        device = resolve_device(device)
        self._mcfg = _mcfg(hidden, lstm_cell_size, model)
        self._double_q = double_q
        self._burn_in = burn_in
        super().__init__(catalog_rq_init(obs_shape, num_actions, self._mcfg,
                                         generator=seeded(seed),
                                         device=device), lr, gamma, device)

    def _loss(self, c):
        state_in = (c[sb.STATE_IN_H], c[sb.STATE_IN_C])
        q, _ = catalog_rq_apply_seq(self.module, c[sb.OBS], c[sb.DONE_PREV],
                                    state_in, self._mcfg)      # [B, T, A]
        t = q.shape[1]
        q_taken = taken(q, c[sb.ACTIONS])                      # [B, T]
        with torch.no_grad():
            q_tgt, _ = catalog_rq_apply_seq(self.target, c[sb.OBS],
                                            c[sb.DONE_PREV], state_in,
                                            self._mcfg)
            # Within-sequence targets from step t+1 (shift left).
            if self._double_q:
                v_next = taken(q_tgt[:, 1:], q[:, 1:].argmax(-1))
            else:
                v_next = q_tgt[:, 1:].max(-1).values
            dones = c["dones"][:, :t - 1]
            terms = c[sb.TERMINATEDS][:, :t - 1]
            # done-but-truncated steps have no stored successor obs:
            # drop them from the loss alongside the final step. A
            # TERMINATED step needs no successor (target = reward).
            target = (c[sb.REWARDS][:, :t - 1]
                      + self._gamma * (1.0 - terms) * v_next)
            # The step AFTER a done belongs to a new episode; its value
            # v_next is valid (carry was reset by done_prev) — but the
            # done step itself must not bootstrap across the boundary.
            mask = 1.0 - dones * (1.0 - terms)
            if self._burn_in > 0:
                mask[:, :self._burn_in] = 0.0
        td = (q_taken[:, :t - 1] - target) * mask
        denom = mask.sum().clamp(min=1.0)
        # weights: per-SEQUENCE importance weights (sequence PER).
        loss = (c["weights"][:, None] * td * td).sum() / denom
        # Per-sequence priority signal: mean |td|.
        per_seq = td.abs().sum(-1) / mask.sum(-1).clamp(min=1.0)
        return loss, per_seq


class R2D2(DQN):
    config_class = R2D2Config
    supports_model_config = True   # catalog-built (torso choice applies)

    def _validate_config(self):
        # R2D2 IS the recurrent Q algorithm: skip DQN's no-LSTM check;
        # dueling heads and n-step returns are not implemented on the
        # sequence loss (targets come from the within-sequence t+1).
        if self.algo_config.dueling:
            raise ValueError("R2D2 does not support dueling heads")
        if self.algo_config.n_step != 1:
            raise ValueError("R2D2 bootstraps within the sequence; "
                             "n_step is not supported")

    def _runner_class(self):
        return R2D2Runner

    def _extra_runner_kwargs(self) -> Dict[str, Any]:
        return {"lstm_cell_size": self.algo_config.lstm_cell_size}

    def _make_q_learner(self, probe):
        cfg = self.algo_config
        return R2D2Learner(
            obs_shape_of(probe), probe.num_actions, hidden=cfg.hidden,
            lstm_cell_size=cfg.lstm_cell_size, lr=cfg.lr,
            gamma=cfg.gamma, double_q=cfg.double_q, burn_in=cfg.burn_in,
            model=cfg.model, seed=cfg.seed, device=cfg.device)

    def build_learner(self):
        cfg = self.algo_config
        probe = make_env(cfg.env, cfg.env_config)
        self.learner = self._make_q_learner(probe)
        # Sequence replay: a SampleBatch row = one whole sequence, so
        # the step-denominated capacity knob converts to sequences
        # (same memory budget as the feedforward family).
        self.replay = self._make_replay(
            max(1, cfg.replay_buffer_capacity
                // cfg.rollout_fragment_length))
        self._steps_sampled = 0
        self._last_target_sync = 0
        self.broadcast_weights(self.learner.get_weights())

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        eps = self._epsilon()
        seq_batches = self._rt.get(
            [er.sample_sequences.remote(cfg.rollout_fragment_length, eps)
             for er in self.env_runners])
        batch = concat_samples(seq_batches)
        self.replay.add(batch)
        steps = len(batch) * cfg.rollout_fragment_length
        self._steps_sampled += steps
        metrics: Dict[str, Any] = {
            "epsilon": eps, "replay_sequences": len(self.replay),
            "num_env_steps_sampled": steps}
        if len(self.replay) * cfg.rollout_fragment_length \
                >= cfg.learning_starts:
            metrics["loss"] = self._replay_updates()
        self._maybe_sync_target()
        return metrics
