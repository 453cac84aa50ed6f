"""Device milliseconds a step in the port's ``forward`` spans: the loss
function's call in the train step, a span a microbatch (``harness.port_spans``)."""

from harness.port_spans import device_ms


def read(run):
    return device_ms(run, "forward")
