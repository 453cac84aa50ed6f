"""The port of ``ray_tpu/rllib``: networks, the model catalog, learners,
env runners and the algorithms that drive them, in torch.

Each module mirrors its JAX counterpart (``ray_tpu_torch/rllib/catalog.py``
against ``ray_tpu/rllib/catalog.py``) and is held against it by
``tests/test_torch_rllib_*.py``. A user trains as with JAX:
``PPOConfig().environment("CartPole-v1").build().train()``. The learners
and runners sit on ``config.device`` (None -> the card;
``.resources(device="cpu")`` for the plain path). The runners live behind
a runtime: ``build(runtime=ray_tpu)`` makes them ``ray_tpu`` actors as in
JAX; with none, ``local_runtime`` runs them in this process (the port's
stand-in for a runtime, not a feature JAX lacks). The pure-numpy modules
(``sample_batch``, ``env``, ``connectors``, ``replay_buffer``,
``offline``) and ``tune.Trainable`` are the port's own copies.
"""

from ray_tpu_torch.rllib.env import (CartPoleEnv, EnvSpec, MultiAgentEnv,
                                     MultiCartPole, PendulumEnv, make_env,
                                     register_env)
from ray_tpu_torch.rllib.sample_batch import (MultiAgentBatch, SampleBatch,
                                              concat_samples)
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.impala import Impala, ImpalaConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.td3 import (DDPG, DDPGConfig, TD3,
                                                TD3Config)
from ray_tpu_torch.rllib.algorithms.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.es import ARS, ARSConfig, ES, ESConfig
from ray_tpu_torch.rllib.algorithms.pg import PG, PGConfig
from ray_tpu_torch.rllib.algorithms.c51 import C51, C51Config
from ray_tpu_torch.rllib.algorithms.apex import ApexDQN, ApexDQNConfig
from ray_tpu_torch.rllib.algorithms.qrdqn import QRDQN, QRDQNConfig
from ray_tpu_torch.rllib.algorithms.noisy import NoisyDQN, NoisyDQNConfig
from ray_tpu_torch.rllib.algorithms.r2d2 import R2D2, R2D2Config
from ray_tpu_torch.rllib.offline import JsonReader, JsonWriter
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)
from ray_tpu_torch.rllib import connectors

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "Impala",
    "ImpalaConfig", "APPO", "APPOConfig", "DQN", "DQNConfig", "BC",
    "BCConfig", "SAC", "SACConfig", "TD3", "TD3Config", "DDPG",
    "DDPGConfig", "CQL", "CQLConfig", "MARWIL", "MARWILConfig",
    "A2C", "A2CConfig", "ES", "ESConfig", "ARS", "ARSConfig",
    "PG", "PGConfig", "C51", "C51Config", "ApexDQN", "ApexDQNConfig",
    "QRDQN", "QRDQNConfig", "NoisyDQN", "NoisyDQNConfig",
    "R2D2", "R2D2Config",
    "connectors", "EnvSpec", "CartPoleEnv",
    "PendulumEnv", "MultiAgentEnv", "MultiCartPole", "make_env",
    "register_env", "SampleBatch", "MultiAgentBatch", "concat_samples",
    "ReplayBuffer", "PrioritizedReplayBuffer", "JsonReader", "JsonWriter",
]
