"""Environments: gym-style API + a dependency-free CartPole.

The port's own copy of ``ray_tpu/rllib/env.py`` (numpy only): the same
dynamics, seeds and registry, so a port runner and a JAX runner stepping
envs from one seed see the same observations.

Reference parity: rllib/env/ (EnvRunner-compatible envs). The registry
mirrors rllib's tune.register_env; CartPole-v1 dynamics follow the classic
control formulation so learning curves are comparable.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class Env:
    """Minimal gym-style interface: reset() -> (obs, info);
    step(a) -> (obs, reward, terminated, truncated, info)."""

    observation_dim: int
    # Image envs set the full shape, e.g. (H, W, C); flat envs leave it
    # empty and the catalog uses (observation_dim,).
    observation_shape: Tuple[int, ...] = ()
    num_actions: int
    # Continuous-control envs set these instead of num_actions.
    continuous: bool = False
    action_dim: int = 0
    action_low: float = -1.0
    action_high: float = 1.0

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError


class CartPoleEnv(Env):
    """CartPole-v1 (no gym dependency; same constants/termination)."""

    observation_dim = 4
    num_actions = 2

    def __init__(self, max_steps: int = 500):
        self._rng = np.random.RandomState()
        self._max_steps = max_steps
        self._g = 9.8
        self._mc = 1.0
        self._mp = 0.1
        self._l = 0.5
        self._force = 10.0
        self._dt = 0.02
        self._theta_lim = 12 * 2 * np.pi / 360
        self._x_lim = 2.4
        self._state = None
        self._t = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32).copy(), {}

    def step(self, action):
        x, x_dot, th, th_dot = self._state
        force = self._force if action == 1 else -self._force
        costh, sinth = np.cos(th), np.sin(th)
        total_m = self._mc + self._mp
        pml = self._mp * self._l
        temp = (force + pml * th_dot ** 2 * sinth) / total_m
        th_acc = (self._g * sinth - costh * temp) / (
            self._l * (4.0 / 3.0 - self._mp * costh ** 2 / total_m))
        x_acc = temp - pml * th_acc * costh / total_m
        x = x + self._dt * x_dot
        x_dot = x_dot + self._dt * x_acc
        th = th + self._dt * th_dot
        th_dot = th_dot + self._dt * th_acc
        self._state = np.array([x, x_dot, th, th_dot])
        self._t += 1
        terminated = bool(abs(x) > self._x_lim or abs(th) > self._theta_lim)
        truncated = self._t >= self._max_steps
        return (self._state.astype(np.float32).copy(), 1.0, terminated,
                truncated, {})


class PendulumEnv(Env):
    """Pendulum-v1 (classic control; no gym dependency): continuous torque
    in [-2, 2], obs (cos th, sin th, th_dot), reward
    -(th^2 + 0.1 th_dot^2 + 0.001 a^2); 200-step episodes."""

    observation_dim = 3
    num_actions = 0
    continuous = True
    action_dim = 1
    action_low = -2.0
    action_high = 2.0

    def __init__(self, max_steps: int = 200):
        self._rng = np.random.RandomState()
        self._max_steps = max_steps
        self._g = 10.0
        self._m = 1.0
        self._l = 1.0
        self._dt = 0.05
        self._state = None
        self._t = 0

    def _obs(self):
        th, th_dot = self._state
        return np.array([np.cos(th), np.sin(th), th_dot], np.float32)

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._state = np.array([self._rng.uniform(-np.pi, np.pi),
                                self._rng.uniform(-1.0, 1.0)])
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        th, th_dot = self._state
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          self.action_low, self.action_high))
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * th_dot ** 2 + 0.001 * u ** 2
        th_dot = th_dot + (3 * self._g / (2 * self._l) * np.sin(th)
                           + 3.0 / (self._m * self._l ** 2) * u) * self._dt
        th_dot = np.clip(th_dot, -8.0, 8.0)
        th = th + th_dot * self._dt
        self._state = np.array([th, th_dot])
        self._t += 1
        return self._obs(), -float(cost), False, self._t >= self._max_steps, {}


class StatelessCartPole(CartPoleEnv):
    """CartPole with the velocity components hidden (obs = [x, theta]) —
    the standard recurrent-model benchmark (reference:
    rllib/examples/envs/classes/stateless_cartpole.py): only a policy with
    memory can estimate the derivatives it needs to balance."""

    observation_dim = 2

    def _mask(self, obs):
        return obs[[0, 2]].astype(np.float32)

    def reset(self, seed: Optional[int] = None):
        obs, info = super().reset(seed)
        return self._mask(obs), info

    def step(self, action):
        obs, r, term, trunc, info = super().step(action)
        return self._mask(obs), r, term, trunc, info


class MemoryCueEnv(Env):
    """Cue-recall memory task: a one-hot cue is visible ONLY at t=0; after
    `delay` blank steps the agent must emit the matching action. Expected
    reward is 1/num_cues for any memoryless policy and 1.0 for a recurrent
    one — a fast, discriminating LSTM test (the T-maze/recall family the
    reference exercises with its RepeatAfterMeEnv example env)."""

    def __init__(self, num_cues: int = 2, delay: int = 3):
        self._n = num_cues
        self._delay = delay
        self.observation_dim = num_cues + 2  # cue one-hot, cue-phase, t/T
        self.num_actions = num_cues
        self._rng = np.random.RandomState()
        self._cue = 0
        self._t = 0

    def _obs(self):
        o = np.zeros(self.observation_dim, np.float32)
        if self._t == 0:
            o[self._cue] = 1.0
            o[self._n] = 1.0
        o[self._n + 1] = self._t / (self._delay + 1)
        return o

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._cue = int(self._rng.randint(self._n))
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        last = self._t == self._delay
        reward = float(int(action) == self._cue) if last else 0.0
        self._t += 1
        return self._obs(), reward, last, False, {}


class GridGoalEnv(Env):
    """Image-observation navigation: an agent (pixel=1.0) moves on an
    n x n grid toward a fixed goal (pixel=0.5). Exercises the catalog's
    CNN torso end-to-end (the vision-net slot of the reference catalog,
    rllib/models/torch/visionnet.py) without any game dependency."""

    def __init__(self, size: int = 5, max_steps: int = 24):
        self._size = size
        self._max_steps = max_steps
        self.observation_shape = (size, size, 1)
        self.observation_dim = size * size
        self.num_actions = 4  # up, down, left, right
        self._rng = np.random.RandomState()
        self._pos = (0, 0)
        self._goal = (size - 1, size - 1)
        self._t = 0

    def _obs(self):
        o = np.zeros(self.observation_shape, np.float32)
        o[self._goal[0], self._goal[1], 0] = 0.5
        o[self._pos[0], self._pos[1], 0] = 1.0
        return o

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        while True:
            self._pos = (int(self._rng.randint(self._size)),
                         int(self._rng.randint(self._size)))
            if self._pos != self._goal:
                break
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        dr, dc = ((-1, 0), (1, 0), (0, -1), (0, 1))[int(action)]
        r = min(max(self._pos[0] + dr, 0), self._size - 1)
        c = min(max(self._pos[1] + dc, 0), self._size - 1)
        self._pos = (r, c)
        self._t += 1
        at_goal = self._pos == self._goal
        reward = 1.0 if at_goal else -0.02
        return (self._obs(), reward, at_goal,
                self._t >= self._max_steps, {})


class MultiAgentEnv:
    """Multi-agent interface (reference: rllib/env/multi_agent_env.py):
    dict-keyed observations/actions/rewards per agent id. Agents may
    finish at different times; a terminated/truncated agent stops
    appearing in later observation dicts. The special "__all__" key
    signals episode end."""

    agents: List[str]
    observation_dim: int      # per-agent (uniform)
    num_actions: int          # per-agent (uniform)

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError


class MultiCartPole(MultiAgentEnv):
    """N independent CartPoles with distinct agent ids — the standard
    smoke-test topology for multi-agent sampling (each agent's stream must
    reach its mapped policy with correct credit)."""

    def __init__(self, num_agents: int = 2, max_steps: int = 200):
        self.agents = [f"agent_{i}" for i in range(num_agents)]
        self._envs = {a: CartPoleEnv(max_steps=max_steps)
                      for a in self.agents}
        self._done: Dict[str, bool] = {}
        self.observation_dim = 4
        self.num_actions = 2

    def reset(self, seed: Optional[int] = None):
        self._done = {a: False for a in self.agents}
        obs = {}
        for i, (a, e) in enumerate(self._envs.items()):
            o, _ = e.reset(seed=None if seed is None else seed + i)
            obs[a] = o
        return obs, {}

    def step(self, action_dict: Dict[str, Any]):
        # A finished agent's FINAL obs stays in the dict (flagged done) so
        # samplers can bootstrap truncated episodes; it simply stops
        # appearing in subsequent steps (reference: multi_agent_env.py
        # returns last observations alongside the done flags).
        obs, rewards, terms, truncs = {}, {}, {}, {}
        for a, act in action_dict.items():
            if self._done[a]:
                continue
            o, r, te, tr, _ = self._envs[a].step(act)
            obs[a], rewards[a] = o, r
            terms[a], truncs[a] = te, tr
            if te or tr:
                self._done[a] = True
        all_done = all(self._done.values())
        terms["__all__"] = all_done
        truncs["__all__"] = all_done
        return obs, rewards, terms, truncs, {}


_ENV_REGISTRY: Dict[str, Callable[[dict], Env]] = {
    "CartPole-v1": lambda cfg: CartPoleEnv(**cfg),
    "Pendulum-v1": lambda cfg: PendulumEnv(**cfg),
    "MultiCartPole": lambda cfg: MultiCartPole(**cfg),
    "StatelessCartPole": lambda cfg: StatelessCartPole(**cfg),
    "MemoryCue": lambda cfg: MemoryCueEnv(**cfg),
    "GridGoal": lambda cfg: GridGoalEnv(**cfg),
}


def register_env(name: str, creator: Callable[[dict], Env]):
    """tune.register_env equivalent (reference: rllib env registry)."""
    _ENV_REGISTRY[name] = creator


def get_env_creator(spec) -> Callable[[dict], Env]:
    """Resolve a spec to its creator callable in the calling process, so
    the callable (not a registry name) ships to EnvRunner actors — worker
    processes have their own empty registry."""
    if isinstance(spec, str):
        if spec not in _ENV_REGISTRY:
            raise ValueError(f"unknown env {spec!r}; "
                             f"register_env() it first")
        return _ENV_REGISTRY[spec]
    if callable(spec):
        return spec
    raise TypeError(f"env spec must be str or callable, got {type(spec)}")


def make_env(spec, config: Optional[dict] = None) -> Env:
    return get_env_creator(spec)(config or {})


class EnvSpec:
    def __init__(self, spec, config: Optional[dict] = None):
        self.spec = spec
        self.config = config or {}

    def make(self) -> Env:
        return make_env(self.spec, self.config)
