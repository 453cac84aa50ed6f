"""Device milliseconds a step in the port's ``reduce`` and ``grad_norm``
spans: the gradients' sums over the batch group and their global norm
(``harness.port_spans``)."""

from harness.port_spans import device_ms


def read(run):
    return device_ms(run, "reduce", "grad_norm")
