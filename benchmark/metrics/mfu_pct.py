"""Model FLOPs a token (``spec.model_flops_per_token``: 6 P + 6 L S d,
nothing recomputed) times the window's tokens a second, over the cards'
bf16 peak: the whole step's share of it."""

from harness.spec import PEAK_FLOPS


def read(run):
    w = run.window
    rate = w.steps * run.tokens_per_step / w.seconds
    flops = run.spec.model_flops_per_token(run.traffic["seq"]) * rate
    return 100.0 * flops / (PEAK_FLOPS[run.traffic["dtype"]] * run.chips)
