"""Device milliseconds of AdamW's update a step: between the device
events recorded around ``update``, the mean over the window's steps."""


def read(run):
    xs = run.window.optimizer_s
    return 1e3 * sum(xs) / len(xs) if xs else None
