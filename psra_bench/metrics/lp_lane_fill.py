"""Share (%) of the LP buffer's lanes that hold a state the LP tier has
to solve: the program's counters ``lp.real_lanes`` (the queue tier 1
leaves, clamped to the buffer) over ``lp.buffer_lanes`` (``max_lp`` of
each screened evaluation)."""
from psra_bench.metrics import _program


def read(view, split):
    got = _program.totals()
    if not got or not got.get("lp.buffer_lanes"):
        return None
    return 100.0 * got.get("lp.real_lanes", 0) / got["lp.buffer_lanes"]
