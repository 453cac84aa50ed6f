"""PyTorch/CUDA port of ray_tpu's compute stack, for one NVIDIA H100.

Each module mirrors its JAX counterpart under ``ray_tpu/`` (for example
``ray_tpu_torch/ops/attention.py`` against ``ray_tpu/ops/attention.py``)
and is held against it by the ``tests/test_torch_*.py`` parity tests. The
package imports torch and numpy only: nothing of JAX and nothing of
``ray_tpu``.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` resolves to ``"cuda"`` and raises where CUDA is absent.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device", "device_where"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the CUDA card; raise if the resolved device is CUDA and
    no card is present. There is no silent CPU fallback: a caller that
    wants the CPU says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


def device_where(device: torch.device) -> dict:
    """Where a computation on ``device`` runs: this process's pid, the
    device, and the card's UUID (None off the card)."""
    uuid = (str(torch.cuda.get_device_properties(device).uuid)
            if device.type == "cuda" else None)
    return {"pid": os.getpid(), "device": str(device), "uuid": uuid}
