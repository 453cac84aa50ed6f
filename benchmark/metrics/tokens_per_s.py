"""Tokens trained in the window on all ranks over the window's host-clock
seconds (from the first step issued to the card's end of the last)."""


def read(run):
    w = run.window
    return w.steps * run.tokens_per_step / w.seconds
