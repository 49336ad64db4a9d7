"""LP buffer lanes a step whose first-pass quality score exceeds the
escalation tolerance, so they ask for the warm rescue (the program's
counter ``lp.rescue_demand``; the rescue takes at most 16 a solve)."""
from psra_bench.metrics import _program


def read(view, split):
    return _program.per_step(view, "lp.rescue_demand")
