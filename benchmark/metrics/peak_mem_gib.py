"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB:
the card memory the run needs, which decides what model and batch fit."""


def read(run):
    return run.peak_bytes / 2 ** 30
