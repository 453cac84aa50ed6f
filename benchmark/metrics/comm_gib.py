"""GiB a step that rank 0's collectives move, counted on their unsharded
side: the ``bytes`` of the port's ``all_gather`` and ``reduce_scatter``
spans (FSDP2's) and ``all_reduce`` spans (the train step's own sums), over
2^30 (``harness.port_spans``)."""

from harness.port_spans import collectives, per_step


def read(run):
    return per_step(run, [s.counts["bytes"] for s in collectives(run)],
                    2.0 ** -30)
