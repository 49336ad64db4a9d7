"""Device ms a step in the sampling layer (``layers.json``: the NSQ
state draw, the SEQ year block's timelines)."""


def read(view, split):
    us = view.layer_us("sampling")
    return us / 1e3 / view.steps if us > 0 and view.steps else None
