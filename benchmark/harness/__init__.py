"""The training benchmark of ``ray_tpu_torch``: the yardstick (shapes,
counts, bounds, peaks), the seeded weights and tokens, the plain reference,
what drives the port's train step, the trace reader and the check of
outputs. ``run.py`` beside this package is the one command."""
