"""PyTorch port: the K1 fused IPM (``ops/ipm_fused.py``) and the structured
LP solver (``engines/lp_ipm_structured.py``).

The plain PyTorch K1 is held against the reference Pallas kernel
``fused_ipm_iterations``, run in interpret mode on the CPU (as
tests/test_ipm_fused.py runs it), on B = 128 stressed RTS-24 lanes: tightly
after 2 iterations, and after the full 16 plus the polish on the LP
objective within 1e-3 p.u. (0.1 MW, tests/test_ipm_fused.py's bound). The
CUDA kernel is held against the plain version on the card in
tests/test_torch_gpu.py.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import (
    dcopf as ref_dcopf, lp_ipm_structured as ref_structured)
from powersystemsreliabilityassessment_tpu.ops import ipm_fused as ref_fused
from powersystemsreliabilityassessment_tpu.utils.config import (
    CompatFlags as RefCompat, IPMConfig as RefIPM)

from powersystemsreliabilityassessment_tpu_torch.core.system import (
    from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    dcopf, lp_ipm_batched, lp_ipm_structured)
from powersystemsreliabilityassessment_tpu_torch.ops import (
    blocked_chol, ipm_fused)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

B = 128


@pytest.fixture(scope="module")
def setup():
    """tests/test_ipm_fused.py's lanes: 3x unavailability, a single line
    outage on every third lane, peak load."""
    ref_sys = ref_build_system(ref_cases.rts24())
    sys_ = from_reference(ref_sys, device="cpu")
    ng, nl, nc = ref_sys.n_gen, ref_sys.n_branch, ref_sys.n_comp
    rng = np.random.default_rng(11)
    down = rng.uniform(size=(B, nc)) < 3 * np.asarray(ref_sys.unavail)[None]
    down[:, 14] = False
    down[np.arange(0, B, 3),
         ng + rng.integers(0, nl, len(range(0, B, 3)))] = True
    gu = (1.0 - down[:, :ng]).astype(np.float32)
    bu = (1.0 - down[:, ng:]).astype(np.float32)
    load = np.tile(np.asarray(ref_sys.load_pd)[None, :], (B, 1))
    ref_vec = ref_dcopf.build_state_lp_vectors(
        ref_sys, jnp.asarray(gu), jnp.asarray(bu), jnp.asarray(load),
        RefCompat(), RefIPM().theta_max)
    vec = dcopf.build_state_lp_vectors(
        sys_, torch.as_tensor(gu), torch.as_tensor(bu),
        torch.as_tensor(load), CompatFlags(), IPMConfig().theta_max)
    return ref_sys, sys_, bu, ref_vec, vec


def _np(t):
    return np.array(t)


def test_lp_vectors_match_reference(setup):
    _, _, _, ref_vec, vec = setup
    for r, g in zip(ref_vec, vec):
        np.testing.assert_array_equal(_np(r), g.numpy())


def test_materialized_lp_matches_reference(setup):
    # The port builds the whole batch at once; the reference one state
    # at a time under vmap (dcopf.py:1243-1246).
    ref_sys, sys_, bu, _, _ = setup
    rng = np.random.default_rng(4)
    gu = (rng.uniform(size=(8, 33)) > 0.1).astype(np.float32)
    load = np.tile(_np(ref_sys.load_pd)[None], (8, 1))
    ref = jax.vmap(lambda g, b_, ld: ref_dcopf.build_state_lp(
        ref_sys, g, b_, ld, RefCompat(), 6.0))(
        jnp.asarray(gu), jnp.asarray(bu[:8]), jnp.asarray(load))
    got = dcopf.build_state_lp(sys_, torch.as_tensor(gu),
                               torch.as_tensor(bu[:8]),
                               torch.as_tensor(load), CompatFlags(), 6.0)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_np(r), g.numpy())


def test_structure_matches_reference(setup):
    ref_sys, sys_, _, _, _ = setup
    ref_st, st = ref_fused.build_structure(ref_sys), \
        ipm_fused.build_structure(sys_)
    np.testing.assert_array_equal(_np(ref_st.a0_bal), st.a0_bal.numpy())
    np.testing.assert_array_equal(_np(ref_st.minc_ref), st.minc_ref.numpy())
    np.testing.assert_array_equal(_np(ref_st.inv_b)[:, 0], st.inv_b.numpy())
    assert (st.n, st.m) == (ref_st.n, ref_st.m) == (112, 62)


def test_structured_products_match_reference(setup):
    ref_sys, sys_, bu, ref_vec, vec = setup
    ref_st, st = ref_fused.build_structure(ref_sys), \
        ipm_fused.build_structure(sys_)
    rng = np.random.default_rng(5)
    v = rng.normal(size=(B, 112)).astype(np.float32)
    y = rng.normal(size=(B, 62)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=(B, 112)).astype(np.float32)
    cs, rcs = vec[4], ref_vec[4]
    bt, bj = torch.as_tensor(bu), jnp.asarray(bu)
    # float32 sums of O(1) terms in another order: 2e-5, as
    # tests/test_ipm_fused.py holds the same products.
    pairs = [
        (ref_structured.mv(ref_st, rcs, bj, jnp.asarray(v)),
         lp_ipm_structured.mv(st, cs, bt, torch.as_tensor(v))),
        (ref_structured.mtv(ref_st, rcs, bj, jnp.asarray(y)),
         lp_ipm_structured.mtv(st, cs, bt, torch.as_tensor(y))),
        (ref_structured.normal_matrix(ref_st, rcs * rcs * jnp.asarray(w), bj),
         lp_ipm_structured.normal_matrix(st, cs * cs * torch.as_tensor(w),
                                         bt)),
    ]
    for r, g in pairs:
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=0, atol=2e-5)


def test_plain_k1_matches_reference_after_two_iterations(setup):
    ref_sys, sys_, bu, ref_vec, vec = setup
    c, b, l, u, cs = vec
    rc, rb, rl, ru, rcs = ref_vec
    ref = ref_fused.fused_ipm_iterations(
        ref_fused.build_structure(ref_sys), rcs, jnp.asarray(bu), rc, rb,
        rl, ru, RefIPM(iterations=2))
    got = ipm_fused.fused_ipm_iterations_plain(
        ipm_fused.build_structure(sys_), cs, torch.as_tensor(bu), c, b, l,
        u, IPMConfig(iterations=2))
    # (x, y, zl, zu, best_score, best_x). Two Newton steps from the same
    # start: only float32 rounding separates them (the reference solves
    # through 8x8 block inverses, the port by plain substitution), held
    # relative to each quantity's scale.
    for name, r, g in zip(("x", "y", "zl", "zu", "best_score", "best_x"),
                          ref, got):
        r, g = _np(r), g.numpy()
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g / scale, r / scale, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_plain_solver_matches_reference_full_iterations(setup):
    ref_sys, sys_, bu, ref_vec, vec = setup
    c, b, l, u, cs = vec
    rc, rb, rl, ru, rcs = ref_vec
    ref = ref_structured.solve_box_lp_structured(
        ref_fused.build_structure(ref_sys), rcs, jnp.asarray(bu), rc, rb,
        rl, ru, RefIPM())
    got = lp_ipm_structured.solve_box_lp_structured(
        ipm_fused.build_structure(sys_), cs, torch.as_tensor(bu), c, b, l,
        u, IPMConfig())
    np.testing.assert_allclose(got.objective.numpy(), _np(ref.objective),
                               rtol=0, atol=1e-3)
    assert float(got.primal_residual.max()) < 2e-3
    assert float(got.objective.max()) > 1.0      # lanes that really shed
    assert bool((got.x >= l - 1e-5).all()) and bool((got.x <= u + 1e-5).all())


def test_lp_route_table():
    k = lp_ipm_batched.lp_kernels(torch.device("cpu"), 62)
    assert k.iterate is ipm_fused.fused_ipm_iterations_plain
    assert lp_ipm_batched.lp_kernels(torch.device("cuda"), 62).iterate \
        is ipm_fused.fused_ipm_iterations
    # 72 < m <= 336: the blocked Cholesky on both devices (its K2 and K3
    # wrappers pick kernel or plain version by the tensor's device).
    for dev in ("cpu", "cuda"):
        k = lp_ipm_batched.lp_kernels(torch.device(dev), 73)
        assert k.factor is blocked_chol.blocked_cholesky
        assert k.solve is blocked_chol.blocked_cho_solve
        assert k.iterate is None
    assert lp_ipm_batched.lp_kernels(torch.device("cuda"), 336).factor \
        is blocked_chol.blocked_cholesky
    # m > 336: the dense xla_chol factor with refinement, any device (the
    # block-Schur bulk pass of solve_box_lp_ops runs K2a / K3 instead).
    for dev in ("cpu", "cuda"):
        k = lp_ipm_batched.lp_kernels(torch.device(dev), 337)
        assert k.factor is lp_ipm_batched._large_factor
        assert k.solve is lp_ipm_batched._large_solve
        assert k.iterate is None
    with pytest.raises(NotImplementedError):
        lp_ipm_batched.lp_kernels(torch.device("meta"), 62)


def test_plain_k1_on_hard_seq_lanes_is_optimal_or_flagged():
    """29 hard SEQ LP lanes of RTS-24 (tests/golden/seq_hard_lanes.npz,
    written by scripts/torch_seq_lane_faults.py --golden: the outage
    states and hourly loads of the lanes of chip_smoke.py seq's 4,096-lane
    buffer, drawn on the card at seed 11, where K1 and the plain version
    part by more than 1e-3 p.u. on the card, or where the plain version
    ends more than 5e-3 p.u. from the optimum on the CPU). The plain
    version and the reference kernel part at the fourth Mehrotra
    iteration, once the barrier weights make the normal matrix
    ill-conditioned, and which lanes then stall depends on the float32
    rounding order (PERF.md §6). What holds on every lane: the
    polished objective is within the evaluator's 5e-3 of the float64
    HiGHS optimum, or the lane's quality score fails the evaluator's
    5e-3 guard, so the evaluator takes the certificate's bound and never
    an off-optimum LP answer. The plain version leaves 6 of the 29
    lanes off (PERF.md §6; bringing it within 5e-3 of HiGHS on these
    lanes is open in ROADMAP.md Queue 3): a seventh is a regression."""
    d = np.load(pathlib.Path(__file__).parent / "golden"
                / "seq_hard_lanes.npz")
    sys_ = from_reference(ref_build_system(ref_cases.rts24()), device="cpu")
    up = 1.0 - torch.as_tensor(d["down"]).float()
    c, b, l, u, cs = dcopf.build_state_lp_vectors(
        sys_, up[:, :33], up[:, 33:].contiguous(), torch.as_tensor(d["load"]),
        CompatFlags(), IPMConfig().theta_max)
    st = ipm_fused.build_structure(sys_)
    args = (cs, up[:, 33:].contiguous(), c, b, l, u)
    sol = lp_ipm_structured.solve_box_lp_structured(st, *args, IPMConfig())
    quality = sol.primal_residual + 2 * st.n * sol.duality_gap
    eye = torch.eye(st.n)
    off = []
    for i in range(c.shape[0]):
        A = ipm_fused.mv(st, cs[i].expand(st.n, -1),
                         args[1][i].expand(st.n, -1), eye).T
        f = lambda t: t.double().numpy()
        r = linprog(f(c[i]), A_eq=f(A), b_eq=f(b[i]),
                    bounds=list(zip(f(l[i]), f(u[i]))), method="highs")
        assert r.status == 0
        if abs(float(sol.objective[i]) - r.fun) > 5e-3:
            off.append(i)
            assert float(quality[i]) > 5e-3, int(d["lane"][i])
    assert len(off) <= 6, off
