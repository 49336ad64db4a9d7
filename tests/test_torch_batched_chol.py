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


def test_k2_difference_on_synthetic_polish_weights_is_conditioning():
    """The 31 lanes where K2a and its plain version differed by more than
    chip_smoke.py's K2_L_BOUND (1e-4; up to 1.9e-4) at the SEQ polish
    shape with synthetic barrier weights (tests/golden/
    k2_synthetic_lanes.npz, from scripts/torch_seq_lanes_dump.py on the
    card and scripts/torch_seq_lane_faults.py --golden: the states,
    hourly loads and the 1e2 / 1e-4 weight mask of lanes of chip_smoke.py
    seq's 4,096-lane buffer, equilibrated A W^-1 A' + I). Factored in float32 by the reference's
    own kernel (Pallas, interpret mode) and by the plain version, both
    land more than K2_L_BOUND from the float64 factor too (the card's
    two results differ by the same order): the matrices' conditioning
    (cond 4.7e4-9.2e4), not K2a, sets the difference, and every float32
    factor stays within cond * eps_f32 of the float64 one."""
    import pathlib
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags)
    d = np.load(pathlib.Path(__file__).parent / "golden"
                / "k2_synthetic_lanes.npz")
    sys_ = build_system(cases.rts24(), device="cpu")
    up = 1.0 - torch.as_tensor(d["down"]).float()
    br_up = up[:, 33:].contiguous()
    *_, cs = dcopf.build_state_lp_vectors(
        sys_, up[:, :33], br_up, torch.as_tensor(d["load"]), CompatFlags(),
        6.0)
    st = ipm_fused.build_structure(sys_)
    w = torch.where(torch.as_tensor(d["wmask"]), 1e2, 1e-4)
    M = ipm_fused.normal_matrix(st, cs * cs / w, br_up) + torch.eye(st.m)
    s = torch.rsqrt(torch.diagonal(M, dim1=1, dim2=2))
    M = (M * s[:, :, None] * s[:, None, :] + 1e-7 * torch.eye(st.m)).numpy()
    n = M.shape[0]
    pad = np.concatenate([M, np.tile(np.eye(st.m, dtype=np.float32),
                                     (B - n, 1, 1))])
    L_ref = np.asarray(ref_bc.from_batch_minor(ref_bc.cholesky_bm(
        ref_bc.to_batch_minor(jnp.asarray(pad)))))[:n]
    L_plain = bc.cholesky_plain(torch.as_tensor(M)).numpy()
    L64 = np.linalg.cholesky(M.astype(np.float64))
    lane = lambda a: np.abs(a).reshape(n, -1).max(1)
    rel = lambda a: lane(a - L64) / np.maximum(lane(L64), 1.0)
    cond = np.linalg.cond(M.astype(np.float64))
    card = d["kernel_vs_plain"]
    assert card.min() > 1e-4                     # the lanes over the bound
    assert rel(L_ref).max() > 1e-4              # the reference off as far
    assert rel(L_plain).max() > 1e-4
    assert (rel(L_ref) <= cond * 2.0 ** -24).all()
    assert (rel(L_plain) <= cond * 2.0 ** -24).all()
