"""Device ms a step in tier 1, the exact certificate (``dcopf.
certify_states`` and ``certify_finish`` outside the LP tier)."""


def read(view, split):
    us = view.layer_us("tier1")
    return us / 1e3 / view.steps if us > 0 and view.steps else None
