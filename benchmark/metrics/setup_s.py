"""From the process's start to the first timed step: imports, the kernel
library, the weights, the first three steps. The check's readings of the
program's state in between are not counted."""


def read(run):
    return run.setup_s
