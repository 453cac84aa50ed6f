"""The 95th percentile of the window's step times: from the device event
after one step (the window's start for the first) to the event after the
next, linearly interpolated between the closest ranks."""


def read(run):
    xs = sorted(run.window.step_s)
    if not xs:
        return None
    pos = 0.95 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return 1e3 * (xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))
