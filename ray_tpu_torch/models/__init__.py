"""Models of the port (``ray_tpu/models``): the GPT, dense or MoE."""

from ray_tpu_torch.models.convert import (load_params, params_from_jax,
                                          params_to_numpy)
from ray_tpu_torch.models.gpt import (GPT, GPTConfig, chunked_xent,
                                      count_params, gpt_backbone,
                                      gpt_forward, gpt_init, gpt_loss)

__all__ = ["GPT", "GPTConfig", "chunked_xent", "count_params",
           "gpt_backbone", "gpt_forward", "gpt_init", "gpt_loss",
           "load_params", "params_from_jax", "params_to_numpy"]
