"""The port's copy of ``ray_tpu.tune``'s class API (``Trainable``), the
base of ``rllib.algorithm.Algorithm``. Tune's controller, searchers and
schedulers hold no JAX and are not copied."""

from ray_tpu_torch.tune.trainable import Trainable

__all__ = ["Trainable"]
