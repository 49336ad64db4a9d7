"""PyTorch port: the K2 batched Cholesky / solve (``ops/batched_chol.py``).

The plain PyTorch versions are held against the reference Pallas kernels
``cholesky_bm`` / ``cho_solve_bm``, run in interpret mode on the CPU
through the reference's own batch-minor layout, on 128 equilibrated SPD
matrices, one of which hits the pivot floor. The CUDA kernels are held
against the plain versions on the card in tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.ops import batched_chol as ref_bc

from powersystemsreliabilityassessment_tpu_torch.ops import (
    batched_chol as bc, cuda_build)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

M_DIM = 62       # RTS-24's LP row count
B = 128


@pytest.fixture(scope="module")
def spd():
    """Equilibrated SPD matrices (unit diagonal plus the 1e-7 ridge, as
    polish_box_lp builds them) with condition numbers up to ~1e4, and
    lane 0 not positive definite: its second pivot 1 - 1.0005^2 < 0 is
    floored (L_11 = -1; an unfloored rsqrt gives NaN)."""
    rng = np.random.default_rng(3)
    G = rng.normal(size=(B, M_DIM, M_DIM + 4)) * rng.uniform(
        0.01, 1.0, size=(B, 1, M_DIM + 4))
    M = G @ G.transpose(0, 2, 1)
    s = 1.0 / np.sqrt(np.einsum("bii->bi", M))
    M = M * s[:, :, None] * s[:, None, :] + 1e-7 * np.eye(M_DIM)
    M[0] = np.eye(M_DIM)
    M[0, 0, 1] = M[0, 1, 0] = 1.0005
    r = rng.normal(size=(B, M_DIM))
    return M.astype(np.float32), r.astype(np.float32)


@pytest.fixture(scope="module")
def ref_factor(spd):
    M, _ = spd
    return ref_bc.cholesky_bm(ref_bc.to_batch_minor(jnp.asarray(M)))


def test_plain_cholesky_matches_reference(spd, ref_factor):
    M, _ = spd
    L_ref = np.asarray(ref_bc.from_batch_minor(ref_factor))
    L = bc.cholesky_plain(torch.as_tensor(M)).numpy()
    # Same algorithm in float32; only rounding order differs. Entries are
    # O(1) for these equilibrated matrices, so 1e-4 absolute is ~1e3 ulp.
    np.testing.assert_allclose(L, L_ref, rtol=0, atol=1e-4)
    assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(L_ref, 1) == 0)
    assert L[0, 1, 1] == pytest.approx(-1.0, abs=1e-3)   # floored pivot
    assert np.isfinite(L).all()


def test_plain_cho_solve_matches_reference(spd, ref_factor):
    _, r = spd
    x_ref = np.asarray(ref_bc.from_batch_minor(ref_bc.cho_solve_bm(
        ref_factor, ref_bc.to_batch_minor(jnp.asarray(r)))))
    L = torch.as_tensor(np.array(ref_bc.from_batch_minor(ref_factor)))
    x = bc.cho_solve_plain(L, torch.as_tensor(r)).numpy()
    # Same factor on both sides: differences are substitution rounding,
    # amplified by cond(L) <= ~1e2; held relative to each lane's scale.
    scale = np.maximum(np.abs(x_ref).max(axis=1, keepdims=True), 1.0)
    np.testing.assert_allclose(x / scale, x_ref / scale, rtol=0, atol=1e-4)


def test_plain_factor_solves_the_system(spd):
    M, r = spd
    Mt, rt = torch.as_tensor(M[1:]).double(), torch.as_tensor(r[1:])
    x = bc.cho_solve_plain(bc.cholesky_plain(torch.as_tensor(M[1:])), rt)
    resid = (Mt @ x.double()[..., None])[..., 0] - rt.double()
    assert float(resid.abs().max()) < 1e-2


def test_wrappers_run_plain_on_cpu(spd):
    M, r = spd
    before = dict(bc.launches)
    Mt = torch.as_tensor(M)
    L = bc.cholesky(Mt)
    assert torch.equal(L, bc.cholesky_plain(Mt))
    assert torch.equal(bc.cho_solve(L, torch.as_tensor(r)),
                       bc.cho_solve_plain(L, torch.as_tensor(r)))
    assert bc.launches == before     # no kernel launched for CPU tensors


@pytest.mark.parametrize("bad,msg", [
    (torch.zeros(2, 3, 3), "CUDA"),
    (torch.zeros(2, 3, 3, dtype=torch.float64, device="meta"), "CUDA"),
])
def test_kernel_operand_checks(bad, msg):
    with pytest.raises(ValueError, match=msg):
        cuda_build.check_operand(bad, "M", (2, 3, 3))
