"""The in-process runtime, kept importable here for RLlib's callers: it
lives in ``ray_tpu_torch/util/local_runtime.py``, which the Train harness
shares."""

from ray_tpu_torch.util.local_runtime import (LocalActor, LocalRef, get,
                                              kill, remote, wait)

__all__ = ["LocalActor", "LocalRef", "get", "kill", "remote", "wait"]
