"""LP lanes a step that the 72 < m <= 336 route's rescue ladder solves
again (the program's counter ``lp.rescue_lanes``): the lanes past the
escalation tolerance (``rescue_demand_per_step``) rounded up to a power
of two of at least 32, capped at the buffer. A program without the
counter gives None."""
from psra_bench.metrics import _program


def read(view, split):
    return _program.per_step(view, "lp.rescue_lanes")
