"""Dense Cholesky with an explicit inverse factor for the large-m LP path.

Port of ``powersystemsreliabilityassessment_tpu/ops/xla_chol.py``
(``factor``, ``solve``, ``inv_spd_equilibrated``). The reference is plain
jnp, not a Pallas kernel: it factors an SPD batch once into the explicit
inverse Cholesky factor L^-1, so that every later solve is two batched
matrix-vector products, and the IPM's iterative refinement (in the
callers) removes the explicit inverse's extra rounding.

``factor`` factors the whole matrix in one block: one
``torch.linalg.cholesky_ex`` and one ``torch.linalg.solve_triangular``
(cuSOLVER and cuBLAS on the card). The reference's 128-wide panels with
an identity-padded corner are a TPU lane tile, and nothing on the port's
path needs them: the large-m LP's dense solves take :func:`chol` and
:func:`cho_solve`, the Schur inverses (m = 300) ``explicit_spd_inv``. On
an NVIDIA H100 80GB HBM3 at 700 W one block factors 32 lanes of m = 792
(the rescue sub-buffer) in 3.29 ms, the panels in 4.65 ms; at 128 and
2,048 lanes the panels are 5% and 25% faster
(``scripts/torch_xla_chol_bench.py``, which keeps the panel variant).

``inv_spd_equilibrated`` takes ``ops/blocked_chol.explicit_spd_inv`` (K2a
and K3) for m <= ``blocked_chol.MAX_M`` (336) on any device and any
batch: the reference takes it only on a TPU at a batch that is a
multiple of 128, since the port's kernels take any batch. A
non-positive-definite block gives NaN, as the reference's
``jnp.linalg.cholesky`` does, so the IPM freezes that lane.

``chol`` and ``cho_solve`` are the factor and the two triangular
substitutions the large-m LP's dense solves take on this port in place
of the explicit inverse (``lp_ipm_batched._large_factor``; PERF.md §6).
"""
from __future__ import annotations

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import blocked_chol


def chol(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of [B, m, m]; NaN on a lane that is not
    positive definite (``jnp.linalg.cholesky``'s result there)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[:, None, None], L, float("nan"))


def cho_solve(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve L L' x = r, r [B, m], by forward and back substitution (two
    batched triangular solves)."""
    y = torch.linalg.solve_triangular(L, r[:, :, None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(1, 2), y,
                                         upper=True)[:, :, 0]


def factor(M: torch.Tensor) -> torch.Tensor:
    """Factor an SPD batch [B, m, m] for repeated :func:`solve` calls:
    the explicit inverse Cholesky factor L^-1 [B, m, m] (reference
    ``xla_chol.py::factor`` returns it padded, with m)."""
    L = chol(M)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def solve(Linv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """M^-1 r, r [B, m], through two batched matrix-vector products with
    L^-1 (no refinement: the callers refine against the retained M);
    mirrors reference ``xla_chol.py::solve``."""
    t = (Linv @ r[:, :, None])[:, :, 0]
    return (t[:, None, :] @ Linv)[:, 0, :]


def inv_spd_equilibrated(M: torch.Tensor, delta: float = 1e-6
                         ) -> torch.Tensor:
    """Explicit [B, m, m] approximation of (M + delta diag(M))^-1: M is
    scaled to a unit diagonal, ridged by ``delta`` I, inverted and scaled
    back. Mirrors reference ``xla_chol.py::inv_spd_equilibrated``; the
    route for m <= ``blocked_chol.MAX_M`` is
    ``blocked_chol.explicit_spd_inv`` (K2a and K3 on the card, their plain
    versions on the CPU) at any batch, else :func:`factor`. The callers
    refine against the true operator."""
    m = M.shape[-1]
    s = torch.rsqrt(torch.clamp_min(torch.diagonal(M, dim1=1, dim2=2),
                                    1e-30))
    eye = torch.eye(m, dtype=M.dtype, device=M.device)
    Ms = (M * s[:, :, None] * s[:, None, :] + delta * eye).contiguous()
    if m <= blocked_chol.MAX_M:
        Minv_s = blocked_chol.explicit_spd_inv(Ms)
    else:
        Linv = factor(Ms)
        Minv_s = Linv.transpose(1, 2) @ Linv
    return Minv_s * s[:, :, None] * s[:, None, :]
