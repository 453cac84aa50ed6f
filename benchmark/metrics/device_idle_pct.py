"""The share of the profiled stretch in which nothing ran on the card
(rank 0): kernels, copies and fills merged into busy intervals."""


def read(run):
    p = run.profile
    if p is None or not p.device_ops:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.window_s)
