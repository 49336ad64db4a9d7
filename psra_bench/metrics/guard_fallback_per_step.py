"""Real LP lanes a step that the evaluator's 5e-3 quality guard sends
back to the certificate's lower bound (the program's counter
``lp.guard_fallback``; padding lanes of the buffer are not counted).
Each such lane's loss of load stays at that bound."""
from psra_bench.metrics import _program


def read(view, split):
    return _program.per_step(view, "lp.guard_fallback")
