"""Device milliseconds a step in the port's ``update`` spans:
``optimizer.update`` called from the train step, the inside reading of
what ``optimizer_ms`` reads from outside (``harness.port_spans``)."""

from harness.port_spans import device_ms


def read(run):
    return device_ms(run, "update")
