"""Connectors: composable obs/action transform pipelines shared across
algorithms.

The port's own copy of ``ray_tpu/rllib/connectors.py`` (numpy only).

Reference parity: rllib/connectors/ (env-to-module pipelines preprocess
observations before the RLModule forward; module-to-env pipelines
postprocess actions before env.step). Here a ConnectorPipeline is a plain
callable chain living inside each EnvRunner actor:

    obs pipeline    : raw env obs batch  -> policy input batch
    action pipeline : policy output batch -> env action batch

Stateful connectors (NormalizeObs) carry running statistics; pipelines are
cloudpickled into runner actors, so each runner keeps independent state
(same as the reference's per-EnvRunner connector state).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class Connector:
    """One transform step. `update=False` applies the transform without
    advancing internal statistics (used for bootstrap/next-obs passes so
    a sample isn't counted twice)."""

    def __call__(self, x: np.ndarray, update: bool = True) -> np.ndarray:
        raise NotImplementedError

    def state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass


class ConnectorPipeline(Connector):
    def __init__(self, connectors: Optional[Sequence[Connector]] = None):
        self.connectors: List[Connector] = list(connectors or [])

    def __call__(self, x, update: bool = True):
        for c in self.connectors:
            x = c(x, update)
        return x

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def state(self) -> dict:
        return {i: c.state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: dict) -> None:
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


# ---------------------------------------------------------------------------
# env -> module (observation) connectors
# ---------------------------------------------------------------------------

class CastObsF32(Connector):
    """float32-cast + NaN/inf scrub (reference: connectors/env_to_module)."""

    def __call__(self, x, update: bool = True):
        x = np.asarray(x, np.float32)
        return np.nan_to_num(x, posinf=3.4e38, neginf=-3.4e38)


class FlattenObs(Connector):
    """Flatten per-row structure to a 1-D feature vector per sample."""

    def __call__(self, x, update: bool = True):
        x = np.asarray(x)
        return x.reshape(x.shape[0], -1) if x.ndim > 2 else x


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, x, update: bool = True):
        return np.clip(x, self.low, self.high)


class NormalizeObs(Connector):
    """Running mean/std normalization (Welford), the MeanStdFilter
    equivalent (reference: connectors/env_to_module/mean_std_filter.py)."""

    def __init__(self, eps: float = 1e-8, clip: float = 10.0):
        self.eps = eps
        self.clip = clip
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def __call__(self, x, update: bool = True):
        x = np.asarray(x, np.float32)
        batch = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x[None, :]
        if self.mean is None:
            self.mean = np.zeros(batch.shape[-1], np.float64)
            self.m2 = np.zeros(batch.shape[-1], np.float64)
        if update and len(batch):
            # Chan parallel-variance merge: one vectorized update per
            # batch instead of a per-row Python loop (hot sampling path).
            n_b = float(len(batch))
            mean_b = batch.mean(axis=0, dtype=np.float64)
            m2_b = ((batch - mean_b) ** 2).sum(axis=0, dtype=np.float64)
            delta = mean_b - self.mean
            total = self.count + n_b
            self.mean += delta * (n_b / total)
            self.m2 += m2_b + delta * delta * (self.count * n_b / total)
            self.count = total
        if self.count < 2:
            return x
        std = np.sqrt(self.m2 / (self.count - 1)) + self.eps
        out = (x - self.mean.astype(np.float32)) / std.astype(np.float32)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def state(self) -> dict:
        return {"count": self.count,
                "mean": None if self.mean is None else self.mean.copy(),
                "m2": None if self.m2 is None else self.m2.copy()}

    def set_state(self, state: dict) -> None:
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


# ---------------------------------------------------------------------------
# module -> env (action) connectors
# ---------------------------------------------------------------------------

class ClipAction(Connector):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def __call__(self, x, update: bool = True):
        return np.clip(x, self.low, self.high)


class UnsquashAction(Connector):
    """[-1, 1] policy output -> [low, high] env range (reference:
    connectors/module_to_env unsquash_actions)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, x, update: bool = True):
        x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
        return self.low + (x + 1.0) * 0.5 * (self.high - self.low)


def default_obs_pipeline(extra: Optional[Sequence[Connector]] = None
                         ) -> ConnectorPipeline:
    return ConnectorPipeline([CastObsF32(), *(extra or [])])


def default_action_pipeline(low, high,
                            extra: Optional[Sequence[Connector]] = None
                            ) -> ConnectorPipeline:
    return ConnectorPipeline([*(extra or []), ClipAction(low, high)])
