"""Device milliseconds a step in the port's ``mla`` spans: the latent
attention block, in the forward and in remat's recompute
(``harness.port_spans``)."""

from harness.port_spans import device_ms


def read(run):
    return device_ms(run, "mla")
