"""Device milliseconds a step in the port's ``experts`` spans: the expert
layer (routing, dispatch, the held and shared experts, the combine), in
the forward and in remat's recompute (``harness.port_spans``)."""

from harness.port_spans import device_ms


def read(run):
    return device_ms(run, "experts")
