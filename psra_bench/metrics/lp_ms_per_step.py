"""Device ms a step in the LP tier (``dcopf._solve_batch`` and
``_finalize``: K1 and the polish at m <= 72, the blocked Cholesky at
72 < m <= 336, the tier's own certificate pass)."""


def read(view, split):
    us = view.layer_us("lp")
    return us / 1e3 / view.steps if us > 0 and view.steps else None
