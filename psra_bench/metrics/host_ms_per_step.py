"""Host ms a step in one layer, ``host_ms_per_step.<layer>.<study>``
with ``<layer>`` one of ``sampling``, ``tier1``, ``lp`` and ``loop``.

Each instant of the traced window (first device operation or runtime
call to the last) goes to the outermost of the program's spans of layer
``sampling``, ``tier1`` or ``lp`` open on the host then (the rule the
device operations follow, so the LP tier's certificate pass counts in
the LP tier), and to the study loop where none is open. The program's
spans keep these host times themselves (``host_ns.<layer>``), and the
loop's is the rest of the window, so the four add up to it."""
from psra_bench.metrics import _program

LAYERS = ("sampling", "tier1", "lp")


def read(view, split):
    layer = split.partition(".")[0]
    got = _program.totals()
    if not got or not view.steps or view.window_us <= 0:
        return None
    host_us = {k: got.get(f"host_ns.{k}", 0) / 1e3 for k in LAYERS}
    if not any(host_us.values()):
        return None
    us = (view.window_us - sum(host_us.values()) if layer == "loop"
          else host_us.get(layer))
    return None if us is None else us / 1e3 / view.steps
