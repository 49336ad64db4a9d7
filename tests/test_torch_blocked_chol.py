"""PyTorch port: the blocked Cholesky and its K3 triangular solves
(``ops/blocked_chol.py``).

The plain K3 versions are held against the reference Pallas kernels
``trsm_fwd`` / ``trsm_bwd``, run in interpret mode on the CPU through the
reference's batch-minor layout. The blocked factor and solve are held
against the reference's on tests/test_ops.py's small multi-panel cases
(PANEL monkeypatched to 5 on both sides), and at RTS-96's full width
(m = 191) against float64 solves of real equilibrated normal matrices;
there the probe that sends lanes to the rescue flags the lanes the
reference's probe flags.
The CUDA kernels are held against the plain versions on the card in
tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.ops import batched_chol as ref_bc
from powersystemsreliabilityassessment_tpu.ops import blocked_chol as ref_bl

from powersystemsreliabilityassessment_tpu_torch.ops import (
    blocked_chol as bl)
from test_torch_gpu import rts96_normal_matrices   # JAX-free, shared

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

EPS_F32 = 2.0 ** -24


def _bm(x):
    """Reference batch-minor layout of a batch-major numpy array."""
    return ref_bc.to_batch_minor(jnp.asarray(x))


# (P, K): small cases, then the path's last panel (23, K = 1), its
# off-diagonal block (56, 23), and the widest panel the kernel takes with
# more right-hand sides than a block's column chunk splits evenly.
@pytest.mark.parametrize("p,k", [(8, 1), (8, 3), (23, 1), (56, 23), (64, 65)],
                         ids=["1", "3", "p23-k1", "p56-k23", "p64-k65"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_plain_trsm_matches_reference(direction, p, k):
    rng = np.random.default_rng(17 + k)
    B, P = ref_bc.LANES, p
    # Off-diagonal scale shrinks as 1/sqrt(P) so cond(L) stays <= ~15 and
    # the solutions O(10) at every P (0.3 at P = 8).
    L = np.tril(rng.normal(size=(B, P, P)), -1) * 0.3 * np.sqrt(8 / P) \
        + np.eye(P) * rng.uniform(0.5, 2.0, size=(B, 1, P))
    Bm = rng.normal(size=(B, P, k))
    L, Bm = L.astype(np.float32), Bm.astype(np.float32)
    ref_fn, fn = {"fwd": (ref_bl.trsm_fwd, bl.trsm_fwd_plain),
                  "bwd": (ref_bl.trsm_bwd, bl.trsm_bwd_plain)}[direction]
    ref = np.asarray(ref_bc.from_batch_minor(ref_fn(_bm(L), _bm(Bm))))
    got = fn(torch.as_tensor(L), torch.as_tensor(Bm)).numpy()
    # The same substitution in float32; the sums run in another order.
    # Entries are <= ~13 with cond(L) <= ~15 here: 1e-5 absolute is ~10
    # ulp at the largest (the widest case differs by 2.9e-6).
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_trsm_wrappers_run_plain_on_cpu():
    rng = np.random.default_rng(5)
    L = torch.as_tensor(np.tril(rng.normal(size=(4, 6, 6)), -1) * 0.2
                        + np.eye(6), dtype=torch.float32)
    Bm = torch.as_tensor(rng.normal(size=(4, 6, 2)), dtype=torch.float32)
    before = dict(bl.launches)
    assert torch.equal(bl.trsm_fwd(L, Bm), bl.trsm_fwd_plain(L, Bm))
    assert torch.equal(bl.trsm_bwd(L, Bm), bl.trsm_bwd_plain(L, Bm))
    assert bl.launches == before     # no kernel launched for CPU tensors
    # L L^-1 B = B: the forward solve inverts the triangle.
    x = bl.trsm_fwd_plain(L, Bm)
    torch.testing.assert_close(L @ x, Bm, rtol=0, atol=1e-5)
    x = bl.trsm_bwd_plain(L, Bm)
    torch.testing.assert_close(L.transpose(1, 2) @ x, Bm, rtol=0, atol=1e-5)


@pytest.mark.parametrize("L,Bm,msg", [
    # A tensor that is not on the CPU never reaches the plain version.
    (torch.zeros(2, 3, 3, device="meta"), torch.zeros(2, 3, 1, device="meta"),
     "CUDA"),
    (torch.zeros(2, 65, 65, device="meta"),
     torch.zeros(2, 65, 1, device="meta"), "P <= 64"),
])
def test_trsm_kernel_operand_checks(L, Bm, msg):
    with pytest.raises(ValueError, match=msg):
        bl.trsm_fwd(L, Bm)


def _small_spd(seed, m, extra, ridge):
    """tests/test_ops.py's small SPD batches."""
    rng = np.random.default_rng(seed)
    B = ref_bc.LANES
    A = rng.normal(size=(B, m, m + extra)).astype(np.float32)
    M = A @ np.swapaxes(A, 1, 2) + ridge * np.eye(m, dtype=np.float32)
    r = rng.normal(size=(B, m)).astype(np.float32)
    return M, r


# tests/test_ops.py:36-89: (seed, m, extra columns, ridge, overrides).
SMALL_CASES = {
    "plain": (2, 12, 4, 8.0, {}),
    "large_lift_refined": (7, 13, 2, 4.0,
                           {"LIFT": 1e-3, "REFINE_STEPS": 3}),
    "rescue_splice": (11, 12, 4, 8.0, {"PROBE_BAD_REL": -1.0}),
}


@pytest.mark.parametrize("case", sorted(SMALL_CASES))
def test_blocked_solve_matches_reference(case, monkeypatch):
    seed, m, extra, ridge, overrides = SMALL_CASES[case]
    for mod in (ref_bl, bl):
        monkeypatch.setattr(mod, "PANEL", 5)   # three panels at m = 12, 13
        for name, value in overrides.items():
            monkeypatch.setattr(mod, name, value)
    M, r = _small_spd(seed, m, extra, ridge)
    # One jit of the whole reference solve (traced after the patches):
    # interpret-mode Pallas runs much faster compiled than op by op.
    ref = np.asarray(jax.jit(lambda a, b: ref_bl.blocked_cho_solve(
        ref_bl.blocked_cholesky(a), b))(jnp.asarray(M), jnp.asarray(r)))
    before = dict(bl.rescues)
    got = bl.blocked_cho_solve(bl.blocked_cholesky(torch.as_tensor(M)),
                               torch.as_tensor(r)).numpy()
    exact = np.linalg.solve(M.astype(np.float64), r[..., None])[..., 0]
    scale = np.abs(exact).max()
    # Both refine to float32 accuracy on these matrices (cond <= ~1e2):
    # tests/test_ops.py holds the reference to 2e-5 of the largest entry.
    assert np.abs(got - exact).max() / scale < 2e-5
    assert np.abs(got - ref).max() / scale < 2e-5
    spliced = int(bl.rescues["lanes"]) - int(before["lanes"])
    flagged = bl.rescues["lanes_flagged"] - before["lanes_flagged"]
    if case == "rescue_splice":
        # Every lane flagged and spliced from the cholesky_ex factor: the
        # splice's panel layout solves as accurately as the kernels'.
        assert spliced == flagged == ref_bc.LANES
        assert bl.rescues["factorizations"] == before["factorizations"] + 1
    else:
        assert spliced == flagged == 0
    assert bl.rescues["lanes_factored"] == \
        before["lanes_factored"] + ref_bc.LANES


def test_panels_match_reference():
    for m in (12, 56, 62, 191, 336):
        assert bl._panels(m) == ref_bl._panels(m)
    assert [j1 - j0 for j0, j1 in bl._panels(191)] == [56, 56, 56, 23]


@pytest.fixture(scope="module")
def rts96_mats():
    """48 real RTS-96 equilibrated normal matrices (see the helper)."""
    return rts96_normal_matrices("cpu", 48)


def test_blocked_solve_full_width_rts96(rts96_mats):
    M = rts96_mats
    assert M.shape == (48, 191, 191)
    r = np.random.default_rng(4).normal(size=(48, 191))
    x = bl.blocked_cho_solve(bl.blocked_cholesky(M),
                             torch.as_tensor(r, dtype=torch.float32))
    x = x.double().numpy()
    M64 = M.double().numpy()
    exact = np.linalg.solve(M64, r[..., None])[..., 0]
    ev = np.linalg.eigvalsh(M64)
    cond = ev[:, -1] / ev[:, 0]
    assert ev[:, 0].min() > 0 and cond.max() > 1e4   # real, ill-conditioned
    # A refined float32 solve lands within ~cond(M) eps of the exact
    # solution (measured: <= 1.07 cond eps over 256 such lanes); 4 cond
    # eps, or 1e-3 on well-conditioned lanes, per lane.
    err = np.abs(x - exact).max(1) / np.maximum(np.abs(exact).max(1), 1.0)
    assert (err <= np.maximum(4 * cond * EPS_F32, 1e-3)).all()
    # Backward error: the residual is small relative to r on every lane.
    res = np.abs(np.einsum("bij,bj->bi", M64, x) - r).max(1) \
        / np.abs(r).max(1)
    assert res.max() < 2e-2 and np.median(res) < 1e-3


@jax.jit
def _ref_probe_err(M):
    """The reference ``blocked_cholesky``'s probe: max |x - 1| per lane of
    M x = M 1 through its factor and refinement schedule (its ``bad`` is
    this above PROBE_BAD_REL)."""
    panels, Ls, Loff = ref_bl._factor_once(M)
    r = jnp.sum(M, axis=2)
    x = ref_bl._blocked_substitute(panels, Ls, Loff, r)
    for _ in range(ref_bl.REFINE_STEPS):
        x = x + ref_bl._blocked_substitute(
            panels, Ls, Loff, r - jnp.einsum("bmn,bn->bm", M, x))
    return jnp.max(jnp.abs(x - 1.0), axis=1)


def test_probe_flags_match_reference_rts96():
    """The rescue's share is the reference's: on real RTS-96 normal
    matrices the port's probe flags the lanes the reference's flags, and
    blocked_cholesky hands exactly those to cholesky_ex."""
    # One block of the reference's batch-minor layout (see the helper).
    M = rts96_normal_matrices("cpu", ref_bc.LANES)
    ref_err = np.asarray(_ref_probe_err(jnp.asarray(M.numpy())))
    ref_bad = ref_err > ref_bl.PROBE_BAD_REL
    bad = bl._probe(*bl._factor_once(M), M).numpy()
    # Ill-conditioned lanes (LIFT x cond > 1) are flagged by both: here
    # a third of the fourth-iteration lanes, none of the polish's A A'.
    assert ref_bad.sum() >= 8 and not ref_bad[M.shape[0] // 2:].any()
    # The two probes differ by rounding only (both within ~10% of each
    # other on these lanes), so they may split only on a lane within 25%
    # of the threshold.
    split = bad != ref_bad
    near = np.abs(np.log(ref_err / ref_bl.PROBE_BAD_REL)) < np.log(1.25)
    assert not (split & ~near).any()
    assert split.sum() <= 1
    before = dict(bl.rescues)
    bl.blocked_cholesky(M)
    assert bl.rescues["lanes_flagged"] - before["lanes_flagged"] == bad.sum()
    assert int(bl.rescues["lanes"]) - int(before["lanes"]) == bad.sum()
