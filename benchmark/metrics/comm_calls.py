"""Calls a step of rank 0's collectives: the port's ``all_gather`` and
``reduce_scatter`` spans (FSDP2's) and ``all_reduce`` spans (the train
step's own sums) (``harness.port_spans``)."""

from harness.port_spans import collectives, per_step


def read(run):
    return per_step(run, [1 for _ in collectives(run)])
