"""Ops of the port: attention and its CUDA kernels (``ray_tpu/ops``)."""

from ray_tpu_torch.ops.attention import (KERNELS, flash_attention,
                                         mha_reference, ring_attention)

__all__ = ["KERNELS", "flash_attention", "mha_reference", "ring_attention"]
