"""A kernel's share (%) of its roofline over the traced steps: the sum of
the bounds of the calls its recorder kept (``kernels/<kernel>.py``) over
the kernel's device time; None where either is missing."""
from psra_bench.kernels import peaks


def share(view, kernel: str, names) -> float | None:
    calls = view.calls.get(kernel) or []
    us = view.kernel_us(*names)
    if not calls or us <= 0:
        return None
    bound = sum(peaks.bound_s(c["flops"], c["bytes"]) for c in calls)
    return 100.0 * bound / (us / 1e6)
