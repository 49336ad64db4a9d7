"""K3, the batched triangular solves ``trsm_fwd`` / ``trsm_bwd``
(``ops/blocked_chol.py``, ``csrc/blocked_trsm.cu``), on the 72 < m <= 336
LP route: the blocked factor's off-diagonal panels (K = the panel below)
and the substitutions of every solve (K = 1).

The recorder wraps the two module names, which the blocked Cholesky
calls. A call solves B lanes of one P x P triangle against P x K right-
hand sides: P^2 K operations a lane; bytes: the triangle read as its
lower half, the right-hand sides read and the solution written, float32.
"""
from __future__ import annotations

KERNEL_NAMES = ("trsm_vec_kernel", "trsm_cols_kernel")


def work(lanes: int, p: int, k: int) -> tuple[float, float]:
    return lanes * p * p * k, 4.0 * lanes * (p * (p + 1) / 2 + 2 * p * k)


def install(tracer):
    from powersystemsreliabilityassessment_tpu_torch.ops import blocked_chol
    undo = []
    for name in ("trsm_fwd", "trsm_bwd"):
        orig = getattr(blocked_chol, name)

        def trsm(L, Bm, _orig=orig):
            if tracer.recording:
                tracer.calls["k3"].append(dict(shape=tuple(Bm.shape)))
            return _orig(L, Bm)

        setattr(blocked_chol, name, trsm)
        undo.append(lambda n=name, o=orig: setattr(blocked_chol, n, o))
    return undo


def count(calls: list) -> None:
    """Each record's operations and bytes, from its shape."""
    for rec in calls:
        lanes, p, k = rec["shape"]
        rec["flops"], rec["bytes"] = work(lanes, p, k)
