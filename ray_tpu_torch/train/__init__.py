"""Training of the port (``ray_tpu/train``): the train step, on one device
or over a mesh with any strategy, and sharded checkpoints of its state."""

from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree
from ray_tpu_torch.train.train_step import (AdamW, TrainState, adamw,
                                            init_train_state,
                                            make_eval_step, make_train_step)

__all__ = ["AdamW", "TrainState", "adamw", "init_train_state",
           "load_pytree", "make_eval_step", "make_train_step", "save_pytree"]
