"""EnvRunner: steps environments with the current policy; the port of
``ray_tpu/rllib/env_runner.py``.

Reference parity: rllib/env/env_runner.py:15 + evaluation/rollout_worker.py
:159. The envs, connectors and action draws are numpy on the host, as in
JAX: actions come from the runner's ``np.random.RandomState(seed)``, so a
port runner and a JAX runner with the same seed and weights draw the same
actions. The policy forward runs on the runner's device (None -> the card)
without autograd, and its outputs are read back to the host once per
vectorized env step, as the reference reads its logits. Weights arrive as
a state dict from a learner on any device (``set_weights``).
``ContinuousEnvRunner`` draws its Gaussian noise on the device from a
``torch.Generator`` (JAX draws it from its key), and takes JAX's draws
when they are passed in.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.catalog import (ModelConfig, catalog_apply,
                                         catalog_apply_step, catalog_init,
                                         obs_shape_of)
from ray_tpu_torch.rllib.connectors import (default_action_pipeline,
                                            default_obs_pipeline)
from ray_tpu_torch.rllib.convert import ravel, unravel
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.models import (det_actor_apply, det_actor_init,
                                        policy_value_apply,
                                        policy_value_init, seeded,
                                        squashed_gaussian_init,
                                        squashed_gaussian_sample)
from ray_tpu_torch.rllib.sample_batch import (MultiAgentBatch, SampleBatch,
                                              compute_gae)


def _to_device(x, device):
    if isinstance(x, (tuple, list)):
        return tuple(_to_device(v, device) for v in x)
    return torch.as_tensor(x, device=device)


def _to_host(x):
    if isinstance(x, (tuple, list)):
        return tuple(_to_host(v) for v in x)
    return x.cpu().numpy()


def run_policy(fn, module, device, *args):
    """``fn(module, *args)`` on ``device`` without autograd, numpy in and
    numpy out (nested tuples kept): one host read of each output."""
    with torch.no_grad():
        return _to_host(fn(module, *_to_device(args, device)))


def with_weights(module, weights):
    """A copy of ``module`` holding ``weights`` (a state dict of tensors or
    arrays): JAX's apply with given params."""
    m = copy.deepcopy(module)
    m.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    return m


class _RewardTracker:
    """Episode-reward bookkeeping shared by the runner flavors: each
    finished episode's return is appended to ``self._done_rewards``."""

    def episode_rewards(self, clear: bool = True) -> List[float]:
        out = list(self._done_rewards)
        if clear:
            self._done_rewards.clear()
        return out

    def ping(self):
        return True


class EnvRunner(_RewardTracker):
    def __init__(self, env_spec, env_config: dict, num_envs: int,
                 seed: int, hidden=(64, 64), obs_connectors=None,
                 model=None, device=None):
        self.device = resolve_device(device)
        self._env_spec = env_spec
        self._env_config = dict(env_config or {})
        self._envs = [make_env(env_spec, env_config) for _ in range(num_envs)]
        self._obs = []
        self._ep_rewards = [0.0] * num_envs
        self._done_rewards: List[float] = []
        for i, e in enumerate(self._envs):
            obs, _ = e.reset(seed=seed + i)
            self._obs.append(obs)
        self._rng = np.random.RandomState(seed)
        # env->module connector pipeline: every obs batch goes through it
        # before the policy forward AND before storage, so the learner
        # trains in the same (preprocessed) observation space.
        self._obs_conn = default_obs_pipeline(obs_connectors)
        self._recurrent = False
        self._build_policy(seed, hidden, model)

    def _build_policy(self, seed: int, hidden, model):
        """Construct self.module + the forward. Subclasses with a
        different head (e.g. C51's distributional Q) override JUST this."""
        e0 = self._envs[0]
        gen = seeded(seed)
        if model is not None:
            # Catalog path (reference: ModelCatalog.get_model_v2): obs
            # shape drives CNN-vs-MLP; use_lstm threads a carry through
            # sampling (state rows reset on episode end).
            mcfg = self._mcfg = ModelConfig.from_dict(model)
            self.module = catalog_init(obs_shape_of(e0), e0.num_actions,
                                       mcfg, generator=gen,
                                       device=self.device)
            self._recurrent = mcfg.use_lstm
            if self._recurrent:
                z = np.zeros((len(self._envs), mcfg.lstm_cell_size),
                             np.float32)
                self._state = [z, z.copy()]
                self._step_fn = (lambda p, o, s:
                                 catalog_apply_step(p, o, s, mcfg))
            else:
                self._forward = lambda p, o: catalog_apply(p, o, mcfg)
        else:
            self.module = policy_value_init(
                e0.observation_dim, e0.num_actions, tuple(hidden),
                generator=gen, device=self.device)
            self._forward = policy_value_apply

    def _policy(self, obs_arr, module=None):
        """The forward on a numpy obs batch -> numpy outputs."""
        module = self.module if module is None else module
        return run_policy(self._forward, module, self.device, obs_arr)

    def _step(self, obs_arr, state, module=None):
        """The recurrent step on numpy obs and (h, c) -> numpy outputs."""
        module = self.module if module is None else module
        return run_policy(self._step_fn, module, self.device, obs_arr, state)

    def set_weights(self, weights):
        self.module.load_state_dict(weights)

    def sample(self, num_steps: int, gamma: float = 0.99,
               lam: float = 0.95) -> SampleBatch:
        """Collect num_steps per env; returns a postprocessed batch with
        GAE advantages."""
        if self._recurrent:
            return self._sample_recurrent(num_steps, gamma, lam)
        n_envs = len(self._envs)
        cols = (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.TERMINATEDS,
                sb.TRUNCATEDS, sb.LOGPS, sb.VF_PREDS, sb.BOOTSTRAP_VALUES)
        per_env: List[Dict[str, List]] = [
            {k: [] for k in cols} for _ in range(n_envs)]
        for _t in range(num_steps):
            obs_arr = self._obs_conn(np.stack(self._obs))
            logits, values = self._policy(obs_arr)
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            for i, env in enumerate(self._envs):
                a = self._rng.choice(len(probs[i]), p=probs[i])
                logp = np.log(probs[i][a] + 1e-10)
                obs2, r, term, trunc, _ = env.step(a)
                rec = per_env[i]
                rec[sb.OBS].append(obs_arr[i])
                rec[sb.ACTIONS].append(a)
                rec[sb.REWARDS].append(r)
                rec[sb.TERMINATEDS].append(term)
                rec[sb.TRUNCATEDS].append(trunc)
                rec[sb.LOGPS].append(logp)
                rec[sb.VF_PREDS].append(values[i])
                # Truncated (not terminated) steps bootstrap from V of the
                # next obs BEFORE the reset wipes it.
                boot = 0.0
                if trunc and not term:
                    nxt = self._obs_conn(obs2[None, :], update=False)
                    boot = float(self._policy(nxt)[1][0])
                rec[sb.BOOTSTRAP_VALUES].append(boot)
                self._ep_rewards[i] += r
                if term or trunc:
                    self._done_rewards.append(self._ep_rewards[i])
                    self._ep_rewards[i] = 0.0
                    obs2, _ = env.reset()
                self._obs[i] = obs2
        obs_arr = self._obs_conn(np.stack(self._obs), update=False)
        _, last_values = self._policy(obs_arr)
        return self._postprocess(per_env, last_values, gamma, lam)

    @staticmethod
    def _postprocess(per_env, last_values, gamma, lam) -> SampleBatch:
        batches = []
        for i, cols in enumerate(per_env):
            b = SampleBatch({k: np.asarray(v) for k, v in cols.items()})
            last_v = 0.0 if b[sb.TERMINATEDS][-1] else float(last_values[i])
            batches.append(compute_gae(b, last_v, gamma, lam))
        return sb.concat_samples(batches)

    def _sample_recurrent(self, num_steps: int, gamma: float,
                          lam: float) -> SampleBatch:
        """Recurrent rollout: per-env (h, c) carry threads across
        fragments; rows reset to zero on episode end. Each env's T steps
        form one contiguous training sequence, with per-step done_prev and
        state_in columns so the learner's loop replays the exact carries
        (reference: recurrent sampling in rollout_worker + the
        max_seq_len trajectory-view machinery)."""
        n_envs = len(self._envs)
        cols = (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.TERMINATEDS,
                sb.TRUNCATEDS, sb.LOGPS, sb.VF_PREDS, sb.BOOTSTRAP_VALUES,
                sb.DONE_PREV, sb.STATE_IN_H, sb.STATE_IN_C)
        per_env: List[Dict[str, List]] = [
            {k: [] for k in cols} for _ in range(n_envs)]
        done_prev = np.zeros(n_envs, np.float32)
        for _t in range(num_steps):
            obs_arr = self._obs_conn(np.stack(self._obs))
            h_in, c_in = self._state
            logits, values, (h2, c2) = self._step(obs_arr, (h_in, c_in))
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            for i, env in enumerate(self._envs):
                a = self._rng.choice(len(probs[i]), p=probs[i])
                obs2, r, term, trunc, _ = env.step(a)
                rec = per_env[i]
                rec[sb.OBS].append(obs_arr[i])
                rec[sb.ACTIONS].append(a)
                rec[sb.REWARDS].append(r)
                rec[sb.TERMINATEDS].append(term)
                rec[sb.TRUNCATEDS].append(trunc)
                rec[sb.LOGPS].append(np.log(probs[i][a] + 1e-10))
                rec[sb.VF_PREDS].append(values[i])
                rec[sb.DONE_PREV].append(done_prev[i])
                # Per-step carry rows (the learner reads only each
                # sequence's first row): SampleBatch columns must be
                # equal-length, and cell-size rows are small next to obs.
                rec[sb.STATE_IN_H].append(h_in[i])
                rec[sb.STATE_IN_C].append(c_in[i])
                boot = 0.0
                if trunc and not term:
                    nxt = self._obs_conn(obs2[None], update=False)
                    boot = float(self._step(
                        nxt, (h2[i:i + 1], c2[i:i + 1]))[1][0])
                rec[sb.BOOTSTRAP_VALUES].append(boot)
                self._ep_rewards[i] += r
                done_prev[i] = 0.0
                if term or trunc:
                    self._done_rewards.append(self._ep_rewards[i])
                    self._ep_rewards[i] = 0.0
                    obs2, _ = env.reset()
                    h2[i] = 0.0
                    c2[i] = 0.0
                    done_prev[i] = 1.0
                self._obs[i] = obs2
            self._state = [h2, c2]
        obs_arr = self._obs_conn(np.stack(self._obs), update=False)
        _lg, last_values, _st = self._step(obs_arr, tuple(self._state))
        return self._postprocess(per_env, last_values, gamma, lam)

    def sample_transitions(self, num_steps: int,
                           epsilon: float = 0.0) -> SampleBatch:
        """(obs, action, reward, next_obs, done) tuples with epsilon-greedy
        over the policy head's scores — the value-based (DQN-family)
        collection mode (reference: RolloutWorker with
        EpsilonGreedy exploration)."""
        if self._recurrent:
            raise ValueError("DQN-family transition sampling does not "
                             "support use_lstm (the reference gates this "
                             "behind R2D2)")
        cols = {k: [] for k in (sb.OBS, sb.ACTIONS, sb.REWARDS,
                                sb.NEXT_OBS, sb.TERMINATEDS,
                                sb.TRUNCATEDS)}
        for _t in range(num_steps):
            obs_arr = self._obs_conn(np.stack(self._obs))
            scores, _ = self._policy(obs_arr)
            for i, env in enumerate(self._envs):
                if self._rng.rand() < epsilon:
                    a = self._rng.randint(scores.shape[-1])
                else:
                    a = int(np.argmax(scores[i]))
                obs2, r, term, trunc, _ = env.step(a)
                cols[sb.OBS].append(obs_arr[i])
                cols[sb.ACTIONS].append(a)
                cols[sb.REWARDS].append(r)
                cols[sb.NEXT_OBS].append(
                    self._obs_conn(obs2[None, :], update=False)[0])
                cols[sb.TERMINATEDS].append(term)
                cols[sb.TRUNCATEDS].append(trunc)
                self._ep_rewards[i] += r
                if term or trunc:
                    self._done_rewards.append(self._ep_rewards[i])
                    self._ep_rewards[i] = 0.0
                    obs2, _ = env.reset()
                self._obs[i] = obs2
        return SampleBatch({k: np.asarray(v) for k, v in cols.items()})

    def evaluate_return(self, weights, episodes: int = 1,
                        max_steps: int = 500) -> float:
        """Mean greedy-episode return under ``weights`` (a state dict) on a
        FRESH env (the evaluation-worker primitive; also the ES/ARS
        fitness fn)."""
        module = with_weights(self.module, weights)
        env = make_env(self._env_spec, self._env_config)
        total = 0.0
        for _ep in range(episodes):
            obs, _ = env.reset(seed=int(self._rng.randint(2 ** 31)))
            if self._recurrent:
                z = np.zeros((1, self._mcfg.lstm_cell_size), np.float32)
                state = (z, z)
            for _ in range(max_steps):
                x = self._obs_conn(np.asarray(obs)[None], update=False)
                if self._recurrent:
                    logits, _v, state = self._step(x, state, module)
                else:
                    logits, _v = self._policy(x, module)
                obs, r, term, trunc, _ = env.step(int(np.argmax(logits[0])))
                total += r
                if term or trunc:
                    break
        return total / episodes

    def evaluate_perturbations(self, flat_params, seeds: List[int],
                               sigma: float, episodes: int = 1,
                               max_steps: int = 500):
        """Antithetic ES/ARS evaluations: each seed's noise vector is
        REBUILT from the seed (no noise shipping — the reference's
        shared-noise-table trick, rllib/algorithms/es) and scored as
        (R(theta + sigma*eps), R(theta - sigma*eps)). ``flat_params`` is
        ``ravel_pytree``'s vector (``get_flat_params``)."""
        flat = np.asarray(flat_params, np.float32)
        out = []
        for seed in seeds:
            eps = np.random.RandomState(seed).standard_normal(
                flat.shape).astype(np.float32)
            r_pos = self.evaluate_return(
                unravel(self.module, flat + sigma * eps), episodes, max_steps)
            r_neg = self.evaluate_return(
                unravel(self.module, flat - sigma * eps), episodes, max_steps)
            out.append((r_pos, r_neg))
        return out

    def get_flat_params(self) -> np.ndarray:
        return ravel(self.module)


class ContinuousEnvRunner(_RewardTracker):
    """Rollout actor for continuous control (SAC family): actions sampled
    from the tanh-squashed Gaussian actor, or (``policy="deterministic"``,
    DDPG/TD3) mu(s) plus Gaussian noise of expl_noise times the half-range,
    clipped; emits transition batches (reference: rollout_worker.py with
    StochasticSampling / GaussianNoise exploration).

    The forward runs on the runner's device, its standard-normal draw from
    a device ``torch.Generator`` seeded ``seed`` (JAX splits its key once
    per policy step, the port draws once per policy step), and the actions
    are read back once per vectorized step. The warm-up's uniform actions
    come from numpy, as in JAX."""

    def __init__(self, env_spec, env_config: dict, num_envs: int,
                 seed: int, hidden=(64, 64), policy: str = "squashed_gaussian",
                 expl_noise: float = 0.1, obs_connectors=None,
                 action_connectors=None, device=None):
        self.device = resolve_device(device)
        self._envs = [make_env(env_spec, env_config) for _ in range(num_envs)]
        e0 = self._envs[0]
        assert e0.continuous, "ContinuousEnvRunner needs a continuous env"
        low, high = self._low, self._high = e0.action_low, e0.action_high
        self._obs_conn = default_obs_pipeline(obs_connectors)
        self._act_conn = default_action_pipeline(low, high,
                                                 action_connectors)
        self._seed = seed
        self._obs = []
        self._ep_rewards = [0.0] * num_envs
        self._done_rewards: List[float] = []
        for i, e in enumerate(self._envs):
            obs, _ = e.reset(seed=seed + i)
            self._obs.append(obs)
        self._noise = seeded(seed, self.device)
        gen = seeded(seed)
        if policy == "deterministic":
            self.module = det_actor_init(e0.observation_dim, e0.action_dim,
                                         tuple(hidden), generator=gen,
                                         device=self.device)
            sigma = expl_noise * (high - low) / 2.0

            def sample(p, obs, eps):
                a = det_actor_apply(p, obs, low, high) + sigma * eps
                return a.clamp(low, high)
        else:
            self.module = squashed_gaussian_init(
                e0.observation_dim, e0.action_dim, tuple(hidden),
                generator=gen, device=self.device)

            def sample(p, obs, eps):
                return squashed_gaussian_sample(None, p, obs, low, high,
                                                eps=eps)[0]
        self._sample = sample

    def set_weights(self, weights):
        self.module.load_state_dict(weights)

    def sample_transitions(self, num_steps: int, random_until: int = 0,
                           steps_done: int = 0, noise=None) -> SampleBatch:
        """(obs, action, reward, next_obs, done) transitions. The first
        `random_until` total env steps act uniformly at random (SAC warmup
        exploration; reference: sac.py num_steps_sampled_before_learning).
        The warmup RNG mixes the runner seed so parallel runners explore
        independently. ``noise``: the policy steps' standard-normal draws,
        [policy steps, num_envs, action_dim], taken in order in place of
        the runner's generator (JAX's draws, in the parity tests)."""
        cols = {k: [] for k in (sb.OBS, sb.ACTIONS, sb.REWARDS,
                                sb.NEXT_OBS, sb.TERMINATEDS)}
        rng = np.random.RandomState(
            (self._seed * 9973 + steps_done + 1) % (2 ** 31))
        shape = (len(self._envs), self._envs[0].action_dim)
        drawn = 0
        for t in range(num_steps):
            obs_arr = self._obs_conn(np.stack(self._obs))
            if steps_done + t < random_until:
                acts = rng.uniform(self._low, self._high, size=shape)
            else:
                if noise is None:
                    eps = torch.randn(shape, generator=self._noise,
                                      device=self.device)
                else:
                    eps = np.array(noise[drawn], np.float32)
                drawn += 1
                acts = run_policy(self._sample, self.module, self.device,
                                  obs_arr, eps)
            acts = self._act_conn(acts)
            for i, env in enumerate(self._envs):
                obs2, r, term, trunc, _ = env.step(acts[i])
                cols[sb.OBS].append(obs_arr[i])
                cols[sb.ACTIONS].append(acts[i])
                cols[sb.REWARDS].append(r)
                cols[sb.NEXT_OBS].append(
                    self._obs_conn(obs2[None, :], update=False)[0])
                cols[sb.TERMINATEDS].append(term)
                self._ep_rewards[i] += r
                if term or trunc:
                    self._done_rewards.append(self._ep_rewards[i])
                    self._ep_rewards[i] = 0.0
                    obs2, _ = env.reset()
                self._obs[i] = obs2
        return SampleBatch({k: np.asarray(v) for k, v in cols.items()})


class MultiAgentEnvRunner(_RewardTracker):
    """Multi-agent sampling: per-agent episode streams routed to policies
    via policy_mapping_fn, GAE per completed trajectory, one
    MultiAgentBatch out (reference: rllib/env/multi_agent_env.py +
    evaluation/rollout_worker.py:159 multi-policy sampling).

    Vectorized over num_envs env copies; trajectories are keyed
    (env index, agent id) so parallel episodes never mix. Policy ``j``
    is initialised from seed + j, as in JAX."""

    _COLS = (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.TERMINATEDS, sb.TRUNCATEDS,
             sb.LOGPS, sb.VF_PREDS, sb.BOOTSTRAP_VALUES)

    def __init__(self, env_spec, env_config: dict, policies: List[str],
                 policy_mapping_fn, num_envs: int = 1, seed: int = 0,
                 hidden=(64, 64), device=None):
        self.device = resolve_device(device)
        self._envs = [make_env(env_spec, env_config)
                      for _ in range(num_envs)]
        self._mapping = policy_mapping_fn
        self._rng = np.random.RandomState(seed)
        e0 = self._envs[0]
        self.modules = {
            pid: policy_value_init(e0.observation_dim, e0.num_actions,
                                   tuple(hidden), generator=seeded(seed + j),
                                   device=self.device)
            for j, pid in enumerate(policies)
        }
        self._obs: List[Dict[str, Any]] = []
        for i, e in enumerate(self._envs):
            obs, _ = e.reset(seed=seed + i)
            self._obs.append(obs)
        self._ep_rewards: Dict[tuple, float] = {}
        self._done_rewards: List[float] = []
        # (env idx, agent id) -> in-progress trajectory columns
        self._traj: Dict[tuple, Dict[str, list]] = {}

    def set_weights(self, weights: Dict[str, Any]):
        """{policy id: state dict}; policies not named keep theirs."""
        for pid, w in weights.items():
            self.modules[pid].load_state_dict(w)

    def _forward(self, pid: str, obs_batch: np.ndarray):
        return run_policy(policy_value_apply, self.modules[pid], self.device,
                          obs_batch)

    def _finish_traj(self, key: tuple, out: Dict[str, list],
                     last_value: float, gamma: float, lam: float):
        cols = self._traj.pop(key, None)
        if not cols or not cols[sb.OBS]:
            return
        b = SampleBatch({k: np.asarray(v) for k, v in cols.items()})
        pid = self._mapping(key[1])
        out.setdefault(pid, []).append(
            compute_gae(b, last_value, gamma, lam))

    def sample(self, num_steps: int, gamma: float = 0.99,
               lam: float = 0.95) -> MultiAgentBatch:
        """Collect num_steps steps PER ENV; returns MultiAgentBatch keyed
        by policy id."""
        done_batches: Dict[str, list] = {}
        for _t in range(num_steps):
            # Gather live (env, agent) pairs across all env copies.
            pairs = []
            for i in range(len(self._envs)):
                if not self._obs[i]:  # every agent finished: new episode
                    self._obs[i], _ = self._envs[i].reset()
                pairs.extend((i, a) for a in self._obs[i])
            obs_arr = np.stack([self._obs[i][a] for i, a in pairs])
            n_act = self._envs[0].num_actions
            logits = np.zeros((len(pairs), n_act), np.float32)
            values = np.zeros((len(pairs),), np.float32)
            by_pid: Dict[str, list] = {}
            for idx, (i, a) in enumerate(pairs):
                by_pid.setdefault(self._mapping(a), []).append(idx)
            for pid, idxs in by_pid.items():
                lg, vl = self._forward(pid, obs_arr[idxs])
                logits[idxs] = lg
                values[idxs] = vl
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            actions = [
                int(self._rng.choice(n_act, p=probs[idx]))
                for idx in range(len(pairs))
            ]
            # Step each env with its agents' actions.
            stepped = []
            for i, env in enumerate(self._envs):
                acts = {a: actions[idx]
                        for idx, (j, a) in enumerate(pairs) if j == i}
                if acts:
                    stepped.append((i, *env.step(acts)))
            results = {i: (obs2, rew, te, tr)
                       for i, obs2, rew, te, tr, _ in stepped}
            for idx, (i, a) in enumerate(pairs):
                obs2, rewards, terms, truncs = results[i]
                term = bool(terms.get(a, False))
                trunc = bool(truncs.get(a, False))
                rec = self._traj.setdefault(
                    (i, a), {k: [] for k in self._COLS})
                rec[sb.OBS].append(self._obs[i][a])
                rec[sb.ACTIONS].append(actions[idx])
                rec[sb.REWARDS].append(rewards.get(a, 0.0))
                rec[sb.TERMINATEDS].append(term)
                rec[sb.TRUNCATEDS].append(trunc)
                rec[sb.LOGPS].append(
                    np.log(probs[idx][actions[idx]] + 1e-10))
                rec[sb.VF_PREDS].append(values[idx])
                boot = 0.0
                if trunc and not term and a in obs2:
                    _lg, bv = self._forward(self._mapping(a),
                                            obs2[a][None, :])
                    boot = float(bv[0])
                rec[sb.BOOTSTRAP_VALUES].append(boot)
                k = (i, a)
                self._ep_rewards[k] = (self._ep_rewards.get(k, 0.0)
                                       + rewards.get(a, 0.0))
                if term or trunc:
                    self._done_rewards.append(self._ep_rewards.pop(k, 0.0))
                    self._finish_traj(k, done_batches, 0.0, gamma, lam)
            # Done agents leave the tracked obs (their final obs was only
            # needed for the truncation bootstrap above).
            for i, *_rest in stepped:
                obs2, rewards, terms, truncs = results[i]
                self._obs[i] = {
                    a: o for a, o in obs2.items()
                    if not (terms.get(a, False) or truncs.get(a, False))}
        # Rollout boundary: close out in-progress trajectories with a
        # bootstrap value from the current obs.
        for (i, a) in list(self._traj.keys()):
            last_v = 0.0
            if a in self._obs[i]:
                _lg, bv = self._forward(self._mapping(a),
                                        self._obs[i][a][None, :])
                last_v = float(bv[0])
            self._finish_traj((i, a), done_batches, last_v, gamma, lam)
        return MultiAgentBatch(
            {pid: sb.concat_samples(bs)
             for pid, bs in done_batches.items()},
            num_steps * len(self._envs))
