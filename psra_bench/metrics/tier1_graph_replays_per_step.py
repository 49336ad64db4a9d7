"""CUDA graph replays a step in tier 1 (the program's counter
``tier1.graph_replays``): one a call of the screened evaluator's own
tier-1 pass (``dcopf.certify_states``) at m <= 72 on the card. A program
without the graph keeps no such counter and gives None; 0 replays (the
counter never fed) gives None too."""
from psra_bench.metrics import _program


def read(view, split):
    return _program.per_step(view, "tier1.graph_replays")
