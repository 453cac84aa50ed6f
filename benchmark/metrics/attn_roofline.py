"""K1-K3's share of their roofline over the profiled stretch: the sum of
each launch's least time (``spec.attn_bound_s`` at the cell's rows,
heads, sequence and head dim, launches from the program's counters) over
the kernels' device time. Nothing when the trace and the counters
disagree on the launches."""

from harness.spec import ATTN_KERNELS, attn_bound_s


def read(run):
    p = run.profile
    if p is None:
        return None
    spec, t = run.spec, run.traffic
    bh = t["batch_per_rank"] * spec.n_heads
    bound = busy = 0.0
    for k in ATTN_KERNELS:
        mine = [d for n, _, d in p.device_ops if k + "_" in n]
        n = p.launches.get(k, 0)
        if n == 0 or len(mine) != n:
            return None
        bound += n * attn_bound_s(k, bh, t["seq"], spec.head_dim,
                                  t["dtype"])[0]
        busy += sum(mine) / 1e9
    return 100.0 * bound / busy
