"""The training benchmark of ``ray_tpu_torch``: the yardstick (bounds,
peaks; a model's shapes and counts are its architecture's, ``archs/``),
the seeded weights and tokens, the plain reference's runner, what drives
the port's train step, the trace reader and the check of outputs.
``run.py`` beside this package is the one command."""
