"""Data of the port (``ray_tpu/data``): the device feed of numpy batches."""

from ray_tpu_torch.data.feed import device_batch_stream

__all__ = ["device_batch_stream"]
