"""The port's spans (``ray_tpu_torch.util.spans``) that started in the
profiled stretch, rank 0's, summed a step for the per-layer readers.
Nothing where the run has no profile, the port records no such span, or
the port has no recorder (a checkout older than it); any other failure to
import the recorder raises."""

RECORDER = "ray_tpu_torch.util.spans"
COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce")


def stretch(run) -> list:
    """The spans that started in the profiled stretch."""
    if run.profile is None:
        return []
    try:
        from ray_tpu_torch.util.spans import recorded
    except ModuleNotFoundError as e:
        if e.name != RECORDER:
            raise
        return []
    return recorded(*run.profile.window)


def per_step(run, values, scale=1.0):
    """``scale`` x the sum of ``values`` over the stretch's steps; None
    where there is none."""
    return scale * sum(values) / run.profile.steps if values else None


def device_ms(run, *names):
    """Device ms a step in the spans ``names``."""
    return per_step(run, [s.device_ns() for s in stretch(run)
                          if s.name in names], 1e-6)


def host_ms(run, *names):
    """Host ms a step in the spans ``names``."""
    return per_step(run, [s.host_ns for s in stretch(run)
                          if s.name in names], 1e-6)


def collectives(run) -> list:
    """The collectives' spans, each with its ``bytes``."""
    return [s for s in stretch(run) if s.name in COLLECTIVES]
