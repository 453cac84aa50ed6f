"""Device milliseconds a step of the attention kernels K1-K3
(``flash_fwd*``, ``flash_bwd_dq*``, ``flash_bwd_dkv*``), in the profiled
stretch."""

from harness.spec import ATTN_KERNELS


def is_attn(name: str) -> bool:
    return any(k in name for k in ATTN_KERNELS)


def read(run):
    p = run.profile
    if p is None:
        return None
    s = p.op_seconds(is_attn)
    return 1e3 * s / p.steps if s > 0 else None
