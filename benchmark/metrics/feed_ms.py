"""Host milliseconds a step in the program's feed (``next()`` on
``device_batch_stream``), the mean over the window's steps."""


def read(run):
    xs = run.window.feed_s
    return 1e3 * sum(xs) / len(xs) if xs else None
