"""Fault E's two candidate repairs of the large-m rescue ladder, on the
card (ROADMAP.md Queue 3 E).

    python3 scripts/torch_case300_guard_candidates.py VARIANT OUT_DIR

VARIANT picks the dense solve of the ladder's compacted sub-solves
(``engines/lp_ipm_batched.py``'s ``_LARGE_KERNELS``), swapped in for this
process only:

  base  the port's own: a float32 factor, two refinement steps with the
        residual r - M dy formed in float32;
  a     the same float32 factor, the residual formed in float64 against
        the retained M and the solution kept in float64 (classical
        mixed-precision refinement);
  b     the factor and both refinement steps in float64.

Each variant runs ``chip_smoke.py``'s lp300 and study300 phases (a
failed check is printed and the run goes on), then
``scripts/torch_case300_guard_lanes.py dump`` over all 16 batches of the
study at seeds 3 and 4 into ``OUT_DIR/e_VARIANT_seedS.npz``, whose
lines count the LP lanes past the guard per batch. Run one variant a
process, all three in one call to compare them on one card.
"""
import importlib.util
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from powersystemsreliabilityassessment_tpu_torch.engines import (  # noqa: E402
    lp_ipm_batched as lb)
from powersystemsreliabilityassessment_tpu_torch.ops import (  # noqa: E402
    xla_chol)


def factor_a(M):
    return xla_chol.chol(M), M.double()


def solve_a(LM, r):
    L, M64 = LM
    x = xla_chol.cho_solve(L, r).double()
    r64 = r.double()
    for _ in range(lb.LARGE_REFINE_STEPS):
        res = r64 - (M64 @ x[:, :, None])[:, :, 0]
        x = x + xla_chol.cho_solve(L, res.float()).double()
    return x.float()


def factor_b(M):
    M64 = M.double()
    return xla_chol.chol(M64), M64


def solve_b(LM, r):
    L, M = LM
    r64 = r.double()
    dy = xla_chol.cho_solve(L, r64)
    for _ in range(lb.LARGE_REFINE_STEPS):
        dy = dy + xla_chol.cho_solve(L, r64 - (M @ dy[:, :, None])[:, :, 0])
    return dy.float()


VARIANTS = {"base": None, "a": (factor_a, solve_a), "b": (factor_b, solve_b)}


def main() -> None:
    if len(sys.argv) != 3 or sys.argv[1] not in VARIANTS:
        raise SystemExit(f"usage: {sys.argv[0]} {{{','.join(VARIANTS)}}} "
                         "OUT_DIR")
    variant, out_dir = sys.argv[1:]
    if VARIANTS[variant] is not None:
        lb._LARGE_KERNELS = lb.LPKernels(*VARIANTS[variant], None)
    print(f"=== variant {variant}", flush=True)
    import chip_smoke as cs
    cs.CARD["smi"] = cs.phase_device()
    cs.phase_build()
    for name, fn in (("lp300", lambda: cs.phase_lp300({})),
                     ("study300", lambda: cs.phase_study300({}))):
        t0 = time.perf_counter()
        try:
            fn()
        except RuntimeError:
            traceback.print_exc()
        print(f"=== {variant} {name} seconds={time.perf_counter() - t0:.1f}",
              flush=True)
    spec = importlib.util.spec_from_file_location(
        "guard_lanes", os.path.join(ROOT, "scripts",
                                    "torch_case300_guard_lanes.py"))
    guard_lanes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(guard_lanes)
    for seed in (3, 4):
        guard_lanes.dump(os.path.join(out_dir, f"e_{variant}_seed{seed}.npz"),
                         range(16), seed)


if __name__ == "__main__":
    main()
