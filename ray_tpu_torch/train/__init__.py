"""Training of the port (``ray_tpu/train``): the train step (one device, or
``dp`` over a mesh)."""

from ray_tpu_torch.train.train_step import (AdamW, TrainState, adamw,
                                            init_train_state,
                                            make_eval_step, make_train_step)

__all__ = ["AdamW", "TrainState", "adamw", "init_train_state",
           "make_eval_step", "make_train_step"]
