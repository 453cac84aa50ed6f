"""ES and ARS: the port of ``ray_tpu/rllib/algorithms/es.py`` (``ESConfig``
:22, ``ES`` :58, ``ARSConfig`` :150, ``ARS`` :164).

Reference parity: rllib/algorithms/es/es.py — derivative-free policy
search (Salimans et al. 2017): each iteration samples antithetic parameter
perturbations, scores them with full greedy episodes on the EnvRunner
fleet, and ascends the centered-rank-weighted noise direction. Noise never
ships: runners rebuild each perturbation from its integer seed (the
shared-noise-table trick). ARS (Mania et al. 2018) rides the same
machinery with top-k direction selection and reward-std scaling
(rllib/algorithms/ars).

theta is ``ravel_pytree``'s flat vector (``rllib/convert.py``), numpy on
the host as in JAX; the noise of a seed is numpy's at that length, so a
JAX theta and the port's take the same steps.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig


class ESConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ES)
        self.episodes_per_perturbation = 1
        self.noise_stdev = 0.05
        self.step_size = 0.02
        self.num_perturbations = 16     # antithetic pairs per iteration
        self.max_episode_steps = 500
        self.l2_coeff = 0.005
        self.num_epochs = 1

    def training(self, *, noise_stdev=None, step_size=None,
                 num_perturbations=None, episodes_per_perturbation=None,
                 max_episode_steps=None, l2_coeff=None,
                 **kw) -> "ESConfig":
        super().training(**kw)
        for name, v in (("noise_stdev", noise_stdev),
                        ("step_size", step_size),
                        ("num_perturbations", num_perturbations),
                        ("episodes_per_perturbation",
                         episodes_per_perturbation),
                        ("max_episode_steps", max_episode_steps),
                        ("l2_coeff", l2_coeff)):
            if v is not None:
                setattr(self, name, v)
        return self


def _centered_ranks(x: np.ndarray) -> np.ndarray:
    """Fitness shaping: returns -> centered ranks in [-0.5, 0.5]
    (reference: es/utils.py compute_centered_ranks)."""
    ranks = np.empty(len(x), dtype=np.float32)
    ranks[x.argsort()] = np.arange(len(x), dtype=np.float32)
    return ranks / max(1, len(x) - 1) - 0.5


def _noise(seed: int, shape) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


class ES(Algorithm):
    config_class = ESConfig

    def build_learner(self):
        cfg = self.algo_config
        # copy: a runtime may hand back a read-only view; theta is
        # updated in place every iteration.
        self.theta = np.array(self._rt.get(
            self.env_runners[0].get_flat_params.remote(), timeout=120),
            np.float32, copy=True)
        self._seed_counter = cfg.seed * 100003 + 1
        # Adam-style moments keep the step scale stable across iterations
        # (the reference's Adam optimizer over the flat theta).
        self._m = np.zeros_like(self.theta)
        self._v = np.zeros_like(self.theta)
        self._t = 0

    def _next_seeds(self, n: int):
        out = list(range(self._seed_counter, self._seed_counter + n))
        self._seed_counter += n
        return out

    def _update_theta(self, grad: np.ndarray):
        cfg = self.algo_config
        self._t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        self._m = b1 * self._m + (1 - b1) * grad
        self._v = b2 * self._v + (1 - b2) * grad * grad
        mhat = self._m / (1 - b1 ** self._t)
        vhat = self._v / (1 - b2 ** self._t)
        self.theta += cfg.step_size * mhat / (np.sqrt(vhat) + eps)

    def _perturbation_returns(self, seeds):
        """Fan seeds across runners; -> (r_pos[n], r_neg[n])."""
        cfg = self.algo_config
        chunks = np.array_split(np.asarray(seeds), len(self.env_runners))
        refs = [
            runner.evaluate_perturbations.remote(
                self.theta, [int(s) for s in chunk], cfg.noise_stdev,
                cfg.episodes_per_perturbation, cfg.max_episode_steps)
            for runner, chunk in zip(self.env_runners, chunks)
            if len(chunk)
        ]
        pairs = [p for chunk in self._rt.get(refs, timeout=600)
                 for p in chunk]
        r = np.asarray(pairs, np.float32)
        return r[:, 0], r[:, 1]

    def _gradient(self, seeds, r_pos, r_neg) -> np.ndarray:
        cfg = self.algo_config
        weights = _centered_ranks(np.concatenate([r_pos, r_neg]))
        w = weights[:len(seeds)] - weights[len(seeds):]
        grad = np.zeros_like(self.theta)
        for s, wi in zip(seeds, w):
            grad += wi * _noise(s, self.theta.shape)
        grad /= (2 * len(seeds) * cfg.noise_stdev)
        return grad - cfg.l2_coeff * self.theta

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        seeds = self._next_seeds(cfg.num_perturbations)
        r_pos, r_neg = self._perturbation_returns(seeds)
        self._update_theta(self._gradient(seeds, r_pos, r_neg))
        # Score the updated policy: a zero-sigma "perturbation" evaluates
        # exactly theta (the runner unravels the flat vector itself).
        eval_ref = self.env_runners[0].evaluate_perturbations.remote(
            self.theta, [0], 0.0, 1, cfg.max_episode_steps)
        cur = float(self._rt.get(eval_ref, timeout=600)[0][0])
        both = np.concatenate([r_pos, r_neg])
        return {
            "episode_reward_mean": cur,
            "perturbation_reward_mean": float(np.mean(both)),
            "perturbation_reward_max": float(np.max(both)),
            "theta_norm": float(np.linalg.norm(self.theta)),
        }

    def save_checkpoint(self):
        return {"theta": self.theta.copy(), "t": self._t,
                "m": self._m.copy(), "v": self._v.copy(),
                "iteration": self._iteration}

    def load_checkpoint(self, ckpt):
        # A copy: theta is updated in place, and must not write through to
        # the checkpoint (JAX's np.asarray aliases a float32 theta).
        self.theta = np.array(ckpt["theta"], np.float32)
        self._t = ckpt.get("t", 0)
        self._m = np.asarray(ckpt.get("m", np.zeros_like(self.theta)))
        self._v = np.asarray(ckpt.get("v", np.zeros_like(self.theta)))
        self._iteration = ckpt.get("iteration", 0)


class ARSConfig(ESConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ARS)
        self.top_directions = 8      # use best k of num_perturbations
        self.noise_stdev = 0.05
        self.step_size = 0.05

    def training(self, *, top_directions=None, **kw) -> "ARSConfig":
        super().training(**kw)
        if top_directions is not None:
            self.top_directions = top_directions
        return self


class ARS(ES):
    """Augmented Random Search (reference: rllib/algorithms/ars): keep
    only the top-k directions by max(r_pos, r_neg) and scale the step by
    the std of the surviving returns."""

    config_class = ARSConfig

    def _gradient(self, seeds, r_pos, r_neg) -> np.ndarray:
        cfg = self.algo_config
        k = min(cfg.top_directions, len(seeds))
        order = np.argsort(-np.maximum(r_pos, r_neg))[:k]
        kept = np.concatenate([r_pos[order], r_neg[order]])
        sigma_r = float(kept.std()) or 1.0
        grad = np.zeros_like(self.theta)
        for i in order:
            grad += (r_pos[i] - r_neg[i]) * _noise(seeds[i],
                                                   self.theta.shape)
        return grad / (k * sigma_r)
