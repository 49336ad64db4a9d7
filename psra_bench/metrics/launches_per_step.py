"""Kernel launches a step, from the trace's kernel events."""


def read(view, split):
    if not view.kernels or not view.steps:
        return None
    return len(view.kernels) / view.steps
