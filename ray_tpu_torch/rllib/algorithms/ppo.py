"""PPO: the port of ``ray_tpu/rllib/algorithms/ppo.py`` (``PPOConfig`` :19,
``PPO`` :41).

Reference parity: rllib/algorithms/ppo/ppo.py:405 training_step.
Synchronous: fan out rollouts to all EnvRunners, GAE on the runners,
minibatch-SGD the learner, broadcast weights.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.catalog import obs_shape_of
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.learner import PPOLearner
from ray_tpu_torch.rllib.sample_batch import MultiAgentBatch, concat_samples


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0

    def training(self, *, lambda_=None, clip_param=None, vf_loss_coeff=None,
                 entropy_coeff=None, **kw) -> "PPOConfig":
        super().training(**kw)
        if lambda_ is not None:
            self.lambda_ = lambda_
        if clip_param is not None:
            self.clip_param = clip_param
        if vf_loss_coeff is not None:
            self.vf_loss_coeff = vf_loss_coeff
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        return self


class PPO(Algorithm):
    config_class = PPOConfig
    supports_model_config = True

    def _make_learner(self, probe, seed_offset: int = 0):
        cfg = self.algo_config
        return PPOLearner(
            probe.observation_dim, probe.num_actions,
            hidden=cfg.hidden, lr=cfg.lr,
            clip_param=getattr(cfg, "clip_param", 0.2),
            vf_coeff=getattr(cfg, "vf_loss_coeff", 0.5),
            entropy_coeff=getattr(cfg, "entropy_coeff", 0.0),
            seed=cfg.seed + seed_offset,
            obs_shape=obs_shape_of(probe),
            # MultiAgentEnvRunner builds the legacy MLP; the catalog path
            # is single-agent (matches runner-side construction).
            model=None if cfg.is_multi_agent else cfg.model,
            seq_len=cfg.rollout_fragment_length, device=cfg.device)

    def _all_weights(self):
        return {pid: ln.get_weights() for pid, ln in self.learners.items()}

    def build_learner(self):
        cfg = self.algo_config
        probe = make_env(cfg.env, cfg.env_config)
        if cfg.is_multi_agent:
            # One learner per policy (reference: Learner per module in the
            # MultiRLModule); distinct seeds so policies don't start as
            # clones; weights broadcast as a policy-keyed dict.
            self.learners = {pid: self._make_learner(probe, seed_offset=j)
                             for j, pid in enumerate(cfg.policies)}
            self.broadcast_weights(self._all_weights())
        else:
            self.learner = self._make_learner(probe)
            self.broadcast_weights(self.learner.get_weights())

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        if cfg.is_multi_agent:
            return self._multi_agent_training_step()
        batch = concat_samples(self._rt.get(self.sample_all_runners()))
        metrics = self.learner.update(
            batch, minibatch_size=min(cfg.minibatch_size, len(batch)),
            num_epochs=cfg.num_epochs, seed=cfg.seed + self._iteration)
        self.broadcast_weights(self.learner.get_weights())
        metrics["num_env_steps_sampled"] = len(batch)
        return metrics

    def _multi_agent_training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        ma = MultiAgentBatch.concat_samples(
            self._rt.get(self.sample_all_runners()))
        metrics: Dict[str, Any] = {}
        for pid, pbatch in ma.policy_batches.items():
            if not len(pbatch):
                continue
            m = self.learners[pid].update(
                pbatch, minibatch_size=min(cfg.minibatch_size, len(pbatch)),
                num_epochs=cfg.num_epochs, seed=cfg.seed + self._iteration)
            for k, v in m.items():
                metrics[f"{pid}/{k}"] = v
        self.broadcast_weights(self._all_weights())
        metrics["num_env_steps_sampled"] = ma.env_steps()
        metrics["num_agent_steps_sampled"] = ma.agent_steps()
        return metrics

    def save_checkpoint(self):
        if self.algo_config.is_multi_agent:
            return {"params": self._all_weights(),
                    "iteration": self._iteration}
        return {"params": self.learner.get_weights(),
                "iteration": self._iteration}

    def load_checkpoint(self, ckpt):
        if self.algo_config.is_multi_agent:
            for pid, w in ckpt["params"].items():
                self.learners[pid].set_weights(w)
            self._iteration = ckpt.get("iteration", 0)
            self.broadcast_weights(self._all_weights())
            return
        self.learner.set_weights(ckpt["params"])
        self._iteration = ckpt.get("iteration", 0)
        self.broadcast_weights(self.learner.get_weights())
