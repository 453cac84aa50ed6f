"""Host milliseconds a step in the port's ``step`` spans: the host's wall
time from the train step's call to its return. In the benchmark's closed
loop the host blocks on the card's full launch queue, so wherever the
card is the slower side this reads the card's pace, not what issuing a
step costs the host; it reads the host's own cost only where the host
paces the card (``harness.port_spans``)."""

from harness.port_spans import host_ms


def read(run):
    return host_ms(run, "step")
