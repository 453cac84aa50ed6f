"""The port's copy of ``ray_tpu.tune``'s class API (``Trainable``), the
base of ``rllib.algorithm.Algorithm``, and ``as_tune_trainable``, which
runs a port class under the Tune module handed in. Tune's controller,
searchers and schedulers hold no JAX and are not copied."""

from ray_tpu_torch.tune.trainable import Trainable, as_tune_trainable

__all__ = ["Trainable", "as_tune_trainable"]
