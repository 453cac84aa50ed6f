"""The expert layer's share of its roofline over the profiled stretch: the
forward products of its passes, 2·3·d·moe_d_ff FLOPs for each row computed
on a held expert (the counter ``experts.rows``) and 2·3·d·(n_shared ·
moe_d_ff) for each token of each pass on the shared experts (``experts.
calls`` passes of the traffic's rows times sequence), over the card's
peak, against the device time of the ``experts`` spans. Read the same way
whatever implements the layer. Nothing where the counters and the spans
disagree on the passes."""

from harness.port_spans import stretch
from harness.spec import PEAK_FLOPS


def read(run):
    p = run.profile
    if p is None:
        return None
    spans = [s for s in stretch(run) if s.name == "experts"]
    calls = p.launches.get("experts.calls", 0)
    if not spans or len(spans) != calls:
        return None
    spec, t = run.spec, run.traffic
    tokens = t["batch_per_rank"] * t["seq"]
    flops = 6.0 * spec.d_model * spec.moe_d_ff * (
        p.launches["experts.rows"] + calls * tokens * spec.n_shared)
    busy = sum(s.device_ns() for s in spans) / 1e9
    return 100.0 * flops / PEAK_FLOPS[t["dtype"]] / busy
