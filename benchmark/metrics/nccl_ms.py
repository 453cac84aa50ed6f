"""Device milliseconds a step of NCCL's kernels on rank 0, overlapped with
compute or not, in the profiled stretch."""


def read(run):
    p = run.profile
    if p is None:
        return None
    s = p.op_seconds(lambda n: "nccl" in n.lower())
    return 1e3 * s / p.steps if s > 0 else None
