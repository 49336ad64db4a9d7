"""K2a, the batched Cholesky factor (``ops/batched_chol.py::cholesky``,
``csrc/batched_chol.cu``), on the panels of the 72 < m <= 336 LP route.

The blocked Cholesky (``ops/blocked_chol.py``) factors each diagonal
panel of the normal matrix with K2a through the module's ``cholesky``;
the recorder wraps that name, so it sees the blocked route's calls and
none of the m <= 72 route's, whose kernel table holds the function
itself (and whose calls replay inside CUDA graphs). A call factors B
lanes of one m x m matrix: m^3 / 3 operations a lane; bytes: the
symmetric input read and the triangular output written, each as its
lower triangle, float32.
"""
from __future__ import annotations

KERNEL_NAMES = ("cholesky_lanes_kernel",)


def work(lanes: int, m: int) -> tuple[float, float]:
    tri = m * (m + 1) / 2
    return lanes * m ** 3 / 3, 4.0 * lanes * 2 * tri


def install(tracer):
    from powersystemsreliabilityassessment_tpu_torch.ops import batched_chol
    orig = batched_chol.cholesky

    def cholesky(M):
        if tracer.recording:
            tracer.calls["k2"].append(dict(shape=tuple(M.shape)))
        return orig(M)

    batched_chol.cholesky = cholesky
    return [lambda: setattr(batched_chol, "cholesky", orig)]


def count(calls: list) -> None:
    """Each record's operations and bytes, from its shape."""
    for rec in calls:
        lanes, m, _ = rec["shape"]
        rec["flops"], rec["bytes"] = work(lanes, m)
