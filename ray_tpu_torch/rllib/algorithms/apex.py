"""APEX-DQN: the port of ``ray_tpu/rllib/algorithms/apex.py``
(``ReplayActor`` :32, ``ApexDQNConfig`` :55, ``ApexDQN`` :71).

Reference parity: rllib/algorithms/apex_dqn (Horgan et al. 2018) — the
three decoupled roles:

  - many EnvRunner actors explore with a PER-WORKER epsilon ladder
    (eps_i = eps ** (1 + i/(K-1) * alpha), the reference's
    per-worker-exploration schedule), sampling concurrently;
  - a ReplayActor owns the prioritized buffer, absorbing rollouts and
    serving training batches; it is made through the runtime with no CPU
    of its own, as JAX makes it;
  - the learner trains WHILE rollouts are in flight: training_step kicks
    off all sample_transitions calls, runs its replay updates, and only
    then collects the rollout refs (in process the rollouts have run at
    submission, with the weights the runners held then).

The Q-learner itself is DQNLearner (double-Q, target net) unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig, nstep_transform
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.replay_buffer import PrioritizedReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayActor:
    """Actor wrapper around PrioritizedReplayBuffer (reference:
    apex_dqn's ReplayActor sharding; one shard here — shard by spawning
    several and round-robining adds)."""

    def __init__(self, capacity: int, alpha: float = 0.6, seed: int = 0):
        self._buf = PrioritizedReplayBuffer(capacity, alpha=alpha,
                                            seed=seed)

    def add(self, batch: SampleBatch) -> int:
        self._buf.add(batch)
        return len(self._buf)

    def sample(self, n: int, beta: float = 0.4) -> SampleBatch:
        return self._buf.sample(n, beta=beta)

    def update_priorities(self, idx, prios):
        self._buf.update_priorities(np.asarray(idx), np.asarray(prios))

    def size(self) -> int:
        return len(self._buf)


class ApexDQNConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ApexDQN)
        self.num_env_runners = 4
        self.per_worker_eps_alpha = 7.0   # exploration ladder exponent
        self.epsilon_start = 0.4          # ladder base (reference default)
        self.epsilon_end = 0.0            # ladder is static, not decayed
        self.prioritized_replay = True

    def training(self, *, per_worker_eps_alpha=None, **kw) -> "ApexDQNConfig":
        super().training(**kw)
        if per_worker_eps_alpha is not None:
            self.per_worker_eps_alpha = per_worker_eps_alpha
        return self


class ApexDQN(DQN):
    config_class = ApexDQNConfig

    def build_learner(self):
        cfg = self.algo_config
        probe = make_env(cfg.env, cfg.env_config)
        self.learner = self._make_q_learner(probe)
        self.replay_actor = self._rt.remote(num_cpus=0)(ReplayActor).remote(
            cfg.replay_buffer_capacity, seed=cfg.seed)
        self._steps_sampled = 0
        self._last_target_sync = 0
        k = max(1, cfg.num_env_runners)
        a = cfg.per_worker_eps_alpha
        self._worker_eps: List[float] = [
            cfg.epsilon_start ** (1 + (i / max(1, k - 1)) * a)
            for i in range(k)]
        self.broadcast_weights(self.learner.get_weights())

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        rt = self._rt
        # 1) launch all rollouts (don't wait).
        rollout_refs = [
            er.sample_transitions.remote(cfg.rollout_fragment_length,
                                         self._worker_eps[i])
            for i, er in enumerate(self.env_runners)]
        # 2) train from the replay actor while those are in flight,
        # prefetching batch i+1 during update(batch i) so the learner
        # never idles on an actor round-trip.
        metrics: Dict[str, Any] = {}
        size = rt.get(self.replay_actor.size.remote())
        if size >= cfg.learning_starts:
            losses = []
            next_ref = self.replay_actor.sample.remote(cfg.train_batch_size)
            for i in range(cfg.updates_per_step):
                replayed = rt.get(next_ref)
                if i + 1 < cfg.updates_per_step:
                    next_ref = self.replay_actor.sample.remote(
                        cfg.train_batch_size)
                if not len(replayed):
                    break
                m = self.learner.update(replayed)
                if "batch_indexes" in replayed:
                    self.replay_actor.update_priorities.remote(
                        replayed["batch_indexes"], m["td_error"] + 1e-6)
                losses.append(m["loss"])
            if losses:
                metrics["loss"] = float(np.mean(losses))
            self.broadcast_weights(self.learner.get_weights())
        # 3) collect rollouts into the replay actor.
        add_refs = []
        steps_this_iter = 0
        for ref in rollout_refs:
            batch = rt.get(ref)
            steps_this_iter += len(batch)
            if cfg.n_step > 1:
                batch = nstep_transform(batch, cfg.n_step, cfg.gamma,
                                        cfg.num_envs_per_env_runner)
            add_refs.append(self.replay_actor.add.remote(batch))
        self._steps_sampled += steps_this_iter
        replay_size = max(rt.get(add_refs)) if add_refs else 0
        self._maybe_sync_target()
        metrics.update({
            "replay_size": replay_size,
            "num_env_steps_sampled": steps_this_iter,
            "num_env_steps_sampled_lifetime": self._steps_sampled,
            "worker_epsilons": list(np.round(self._worker_eps, 4)),
        })
        return metrics

    def cleanup(self):
        super().cleanup()
        try:
            self._rt.kill(self.replay_actor)
        except Exception:
            pass
