"""K1's share (%) of its roofline over the traced steps: the sum of the
traced calls' bounds (``kernels/k1.py``) over K1's device time."""
from psra_bench.kernels import k1, peaks


def read(view, split):
    calls = view.calls.get("k1") or []
    us = view.kernel_us(*k1.KERNEL_NAMES)
    if not calls or us <= 0:
        return None
    bound = sum(peaks.bound_s(c["flops"], c["bytes"]) for c in calls)
    return 100.0 * bound / (us / 1e6)
