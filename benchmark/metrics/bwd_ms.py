"""Device milliseconds a step in the port's ``backward`` spans:
``loss.backward()`` in the train step, remat's recompute and FSDP2's waits
for its reduce-scatters included (``harness.port_spans``)."""

from harness.port_spans import device_ms


def read(run):
    return device_ms(run, "backward")
