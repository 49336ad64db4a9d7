"""CUDA graph replays a step in the LP tier (the program's counter
``lp.graph_replays``): three a m <= 72 LP call on the card within the
program's lane cut-off (the polish and the rescue's pick, the rescue's
merge, ``_finalize``), K1 launched eagerly between them. A program
without the graphs keeps no such counter and gives None; 0 replays
(the counter never fed) gives None too."""
from psra_bench.metrics import _program


def read(view, split):
    return _program.per_step(view, "lp.graph_replays")
