"""Device milliseconds a step of the matrix products that cuBLAS and
CUTLASS run (the layers' weight products and the loss head's), in the
profiled stretch; the attention kernels are not among them."""

PATTERNS = ("gemm", "xmma", "nvjet", "cutlass", "cublas", "s16816",
            "s1688", "wgmma")
NOT = ("flash_",)


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in PATTERNS) and not any(n in low for n in NOT)


def read(run):
    p = run.profile
    if p is None:
        return None
    s = p.op_seconds(is_gemm)
    return 1e3 * s / p.steps if s > 0 else None
