"""Share (%) of the traced steps' span, from the first device operation
or runtime call to the last, in which no operation ran on the device."""


def read(view, split):
    if view.window_us <= 0:
        return None
    return 100.0 * (1.0 - view.busy_us / view.window_us)
