"""Training of the port (``ray_tpu/train``): the train step, on one device
or over a mesh with any strategy but the pipeline's."""

from ray_tpu_torch.train.train_step import (AdamW, TrainState, adamw,
                                            init_train_state,
                                            make_eval_step, make_train_step)

__all__ = ["AdamW", "TrainState", "adamw", "init_train_state",
           "make_eval_step", "make_train_step"]
