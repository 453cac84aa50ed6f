"""The yardstick the architectures share: the card's published peaks and
the attention kernels' least times. A configuration's leaves, counts and
attention shapes are its architecture's (``archs/<arch>/spec.py``). Frozen
here so that no change to the program moves it. Imports nothing but the
standard library."""

from __future__ import annotations

from typing import Optional, Tuple

# One NVIDIA H100 SXM (data sheet, dense rates): bf16/fp16 tensor cores,
# fp32 on the CUDA cores, and HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}

# The attention kernels: K1 the forward, K2 dQ, K3 dK and dV.
ATTN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def attn_bound_s(name: str, bh: int, s: int, d: int,
                 dtype: str = "bfloat16",
                 d_v: Optional[int] = None) -> Tuple[float, str]:
    """Least time of one causal launch over queries and keys [bh, s, d]
    and values [bh, s, d_v] (``d_v`` None: ``d``): each input byte read
    once and each output byte written once over HBM bandwidth, against the
    causal FLOPs over the tensor cores' peak. -> (seconds, "bytes" or
    "operations")."""
    dv = d if d_v is None else d_v
    el, row = BYTES[dtype], bh * s * 4
    pairs = bh * s * (s + 1) // 2
    work = {"flash_fwd": (el * bh * s * (2 * d + 2 * dv) + row,
                          2 * pairs * (d + dv)),
            "flash_bwd_dq": (el * bh * s * (3 * d + 2 * dv) + 2 * row,
                             2 * pairs * (2 * d + dv)),
            "flash_bwd_dkv": (el * bh * s * (3 * d + 3 * dv) + 2 * row,
                              4 * pairs * (d + dv))}
    nbytes, flops = work[name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
