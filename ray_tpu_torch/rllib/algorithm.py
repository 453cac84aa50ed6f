"""Algorithm base + fluent AlgorithmConfig: the port of
``ray_tpu/rllib/algorithm.py`` (``AlgorithmConfig`` :19, ``Algorithm``
:127).

Reference parity: rllib/algorithms/algorithm.py:202 (Algorithm extends the
Tune Trainable) and algorithm_config.py:125 (fluent
.environment()/.env_runners()/.training() builder).

The runners live behind a runtime, as in JAX: the four calls JAX makes of
``ray_tpu`` (``remote``, ``get``, ``wait``, ``kill``) are made of
``self._rt``, the runtime handed to ``build(runtime=...)``. With
``runtime=ray_tpu`` the runners are ``ray_tpu`` actors, exactly as in JAX;
with none, ``local_runtime`` runs them in this process. The learners and
the runners sit on ``config.device`` (``resources(device=...)``; None ->
the card, ``"cpu"`` on request).

Weights reach the runners as the learner's state dict. In process they
stay on the device: each runner loads them into its own module (a copy on
the device, no host copy). Through an injected runtime they cross
processes as host tensors: one device-to-host copy per broadcast, never a
CUDA tensor pickled into an actor.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Type

import numpy as np
import torch

from ray_tpu_torch.util import local_runtime
from ray_tpu_torch.tune.trainable import Trainable


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        self.env = "CartPole-v1"
        self.env_config: Dict[str, Any] = {}
        self.num_env_runners = 2
        self.num_envs_per_env_runner = 1
        self.rollout_fragment_length = 200
        self.gamma = 0.99
        self.lr = 5e-4
        self.train_batch_size = 0  # 0 => runners * envs * fragment
        self.minibatch_size = 128
        self.num_epochs = 8
        self.hidden = (64, 64)
        # Full catalog model config dict (fcnet_hiddens / conv_filters /
        # use_lstm / lstm_cell_size); None -> legacy default MLP.
        self.model: Optional[Dict[str, Any]] = None
        self.seed = 0
        # Multi-agent (set via .multi_agent()); declared here so the plain
        # dict config path (Tune param_space) round-trips them too.
        self.policies: Optional[List[str]] = None
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None
        # Connector pipelines (reference: rllib/connectors/): extra
        # env->module obs connectors and module->env action connectors
        # appended to each runner's default pipeline.
        self.obs_connectors: Optional[List[Any]] = None
        self.action_connectors: Optional[List[Any]] = None
        # The learners' and runners' device: None -> the card.
        self.device: Optional[str] = None
        self.extra: Dict[str, Any] = {}

    # -- fluent sections (reference: AlgorithmConfig.environment etc.) ----
    def environment(self, env=None, *, env_config=None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(self, *, num_env_runners=None,
                    num_envs_per_env_runner=None,
                    rollout_fragment_length=None,
                    obs_connectors=None,
                    action_connectors=None) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if obs_connectors is not None:
            self.obs_connectors = list(obs_connectors)
        if action_connectors is not None:
            self.action_connectors = list(action_connectors)
        return self

    def training(self, *, gamma=None, lr=None, train_batch_size=None,
                 minibatch_size=None, num_epochs=None,
                 model=None, **extra) -> "AlgorithmConfig":
        if gamma is not None:
            self.gamma = gamma
        if lr is not None:
            self.lr = lr
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        if minibatch_size is not None:
            self.minibatch_size = minibatch_size
        if num_epochs is not None:
            self.num_epochs = num_epochs
        if model is not None:
            self.model = dict(model)
            if "fcnet_hiddens" in model:
                self.hidden = tuple(model["fcnet_hiddens"])
        self.extra.update(extra)
        return self

    def multi_agent(self, *, policies=None,
                    policy_mapping_fn=None) -> "AlgorithmConfig":
        """Declare policies + the agent->policy mapping (reference:
        algorithm_config.py multi_agent())."""
        if policies is not None:
            self.policies = list(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    @property
    def is_multi_agent(self) -> bool:
        return bool(getattr(self, "policies", None))

    def resources(self, *, device=None) -> "AlgorithmConfig":
        """Where the learners and runners compute: None -> the card,
        ``"cpu"`` for the plain path."""
        if device is not None:
            self.device = device
        return self

    def debugging(self, *, seed=None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self, runtime=None) -> "Algorithm":
        cls = self.algo_class
        if cls is None:
            raise ValueError("no algo_class bound to this config")
        return cls(config=self, runtime=runtime)

    def to_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items()
             if k not in ("algo_class",)}
        return d


def to_host(tree):
    """A state dict (or a dict of them) as host tensors: the form weights
    take to cross into an actor of another process."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    return tree


class Algorithm(Trainable):
    """Base: owns EnvRunner actors; subclasses implement training_step().

    As a tune.Trainable, config may be an AlgorithmConfig or a plain dict
    (Tune param_space path). ``runtime``: the actor runtime the runners
    live behind (``ray_tpu``, or by default ``local_runtime``).
    """

    config_class: Type[AlgorithmConfig] = AlgorithmConfig
    # Algorithms whose learner builds through the model catalog set this;
    # others keep the legacy MLP even if a model config is present (their
    # learner's param layout must match the runner's).
    supports_model_config = False

    def __init__(self, config=None, runtime=None):
        self._rt = local_runtime if runtime is None else runtime
        if isinstance(config, AlgorithmConfig):
            self.algo_config = config
        else:
            self.algo_config = self.config_class(type(self))
            for k, v in (config or {}).items():
                if hasattr(self.algo_config, k):
                    setattr(self.algo_config, k, v)
                else:
                    self.algo_config.extra[k] = v
        self._iteration = 0
        super().__init__(self.algo_config.to_dict()
                         if isinstance(config, AlgorithmConfig)
                         else (config or {}))

    @property
    def in_process(self) -> bool:
        return self._rt is local_runtime

    def _validate_config(self):
        """Driver-side config rejection BEFORE any actor spawns (a bad
        combo must fail with a clear error, not a traceback from inside
        a remote runner). Subclasses extend via super()."""
        cfg = self.algo_config
        if cfg.model is not None and not self.supports_model_config:
            # fcnet_hiddens alone still maps onto the legacy MLP (the
            # base training() mirrors it into cfg.hidden); anything else
            # would be silently dropped — reject instead.
            dropped = set(cfg.model) - {"fcnet_hiddens"}
            if dropped:
                raise ValueError(
                    f"{type(self).__name__} does not support model "
                    f"config keys {sorted(dropped)} (only fcnet_hiddens "
                    f"maps onto its legacy network)")

    # -- Trainable API ------------------------------------------------------
    def setup(self, config: Dict[str, Any]):
        from ray_tpu_torch.rllib.env import get_env_creator
        from ray_tpu_torch.rllib.env_runner import MultiAgentEnvRunner
        cfg = self.algo_config
        self._validate_config()
        # Resolve the env creator here (driver-side registry) so custom
        # registered envs work inside worker processes.
        creator = get_env_creator(cfg.env)
        if cfg.is_multi_agent:
            runner_cls = self._rt.remote(num_cpus=1)(MultiAgentEnvRunner)
            self.env_runners = [
                runner_cls.remote(creator, cfg.env_config,
                                  cfg.policies, cfg.policy_mapping_fn,
                                  num_envs=cfg.num_envs_per_env_runner,
                                  seed=cfg.seed + 1000 * i,
                                  hidden=cfg.hidden, device=cfg.device)
                for i in range(cfg.num_env_runners)
            ]
        else:
            runner_cls = self._rt.remote(num_cpus=1)(self._runner_class())
            extra = self._extra_runner_kwargs()
            self.env_runners = [
                runner_cls.remote(creator, cfg.env_config,
                                  cfg.num_envs_per_env_runner,
                                  seed=cfg.seed + 1000 * i,
                                  hidden=cfg.hidden,
                                  obs_connectors=cfg.obs_connectors,
                                  model=(cfg.model
                                         if self.supports_model_config
                                         else None),
                                  device=cfg.device, **extra)
                for i in range(cfg.num_env_runners)
            ]
        self._episode_rewards: List[float] = []
        self.build_learner()

    def _runner_class(self):
        """Rollout-actor class for the single-agent path; algorithms with
        a custom sampler (e.g. C51's expected-Q scoring) override this
        instead of copying setup()."""
        from ray_tpu_torch.rllib.env_runner import EnvRunner
        return EnvRunner

    def _extra_runner_kwargs(self) -> Dict[str, Any]:
        return {}

    def build_learner(self):
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self) -> Dict[str, Any]:
        self._iteration += 1
        result = self.training_step()
        rewards = []
        for r in self._rt.get(
                [er.episode_rewards.remote() for er in self.env_runners]):
            rewards.extend(r)
        self._episode_rewards.extend(rewards)
        recent = self._episode_rewards[-100:]
        result.setdefault("episode_reward_mean",
                          float(np.mean(recent)) if recent else float("nan"))
        result.setdefault("episodes_total", len(self._episode_rewards))
        result.setdefault("training_iteration", self._iteration)
        return result

    def train(self) -> Dict[str, Any]:
        return self.step()

    def sample_all_runners(self) -> List:
        """Fan out one rollout per runner; returns refs (pipelining is the
        caller's choice)."""
        cfg = self.algo_config
        return [er.sample.remote(cfg.rollout_fragment_length, cfg.gamma,
                                 self.gae_lambda())
                for er in self.env_runners]

    def gae_lambda(self) -> float:
        return getattr(self.algo_config, "lambda_", 0.95)

    def runner_weights(self, params):
        """``params`` as the runners take them: as they are in process,
        as host tensors through an injected runtime."""
        return params if self.in_process else to_host(params)

    def broadcast_weights(self, params):
        params = self.runner_weights(params)
        self._rt.get([er.set_weights.remote(params)
                      for er in self.env_runners])

    def cleanup(self):
        for er in getattr(self, "env_runners", []):
            try:
                self._rt.kill(er)
            except Exception:
                pass

    def stop(self):
        self.cleanup()
