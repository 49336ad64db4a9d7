"""The port's own span and counter totals of the traced steps
(``powersystemsreliabilityassessment_tpu_torch/utils/profiling.py``).

The spans and counters are on exactly while the tracer's profiler
records, so their totals cover the traced steps. A program without them
gives None."""


def totals() -> dict | None:
    try:
        from powersystemsreliabilityassessment_tpu_torch.utils.profiling \
            import counters
    except ImportError:
        return None
    return counters()


def per_step(view, key: str) -> float | None:
    """Total ``key`` over the traced steps, a step; None where the
    program kept none."""
    got = totals()
    if not got or key not in got or not view.steps:
        return None
    return got[key] / view.steps
