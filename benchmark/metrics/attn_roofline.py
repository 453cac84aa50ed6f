"""K1-K3's share of their roofline over the profiled stretch: the sum of
each launch's least time (``attn_bound_s`` at each kind of attention call
of the architecture's ``attn_shapes``: its rows times heads, sequence and
head widths, weighted by its share of the calls; launches from the
program's counters) over the kernels' device time. Nothing when the trace
and the counters disagree on the launches."""

from harness.spec import ATTN_KERNELS, attn_bound_s


def read(run):
    p = run.profile
    if p is None:
        return None
    t = run.traffic
    shapes = run.spec.attn_shapes(t)
    bound = busy = 0.0
    for k in ATTN_KERNELS:
        mine = [d for n, _, d in p.device_ops if k + "_" in n]
        n = p.launches.get(k, 0)
        if n == 0 or len(mine) != n:
            return None
        bound += n * sum(share * attn_bound_s(k, bh, s, d, t["dtype"], dv)[0]
                         for share, bh, s, d, dv in shapes)
        busy += sum(mine) / 1e9
    return 100.0 * bound / busy
