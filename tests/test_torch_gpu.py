"""PyTorch port on a CUDA card: the hand-written kernels (K1-K6)
against their plain PyTorch versions (K1, K2a and K2b also at the SEQ
study's 4,096-lane LP buffer), the blocked Cholesky route on the
kernels against the same route on the plain versions, the RTS-24 main
path on the card against the same path on the CPU, an RTS-96 step that
must launch K2 and K3, K2a and K3 at the case300s block-Schur shapes and
the case300s LP path on eight deep contingencies, tier 1.5
(``certify_island_pf``) on the card against the CPU, the fused sampler-certificate step and the SEQ
step without a host sync, the 98-state golden replay on the card
(tests/test_torch_nsq.py runs it on the CPU through the same helper),
and the NSQ samplers (antithetic, importance, mixture) on the card
against their marginals on the CPU, with each sampler's RTS-24 step
without a host sync; the COPT on the card against the float64 host
table, an enumeration chunk and an island-blackout batch on the card
against the same on the CPU, and the control-variate, enumeration-tail
and blackout steps (NSQ and SEQ) without a host sync; K2a / K2b at the
multi-area LP's shapes (m = 1-5, 70,080 lanes), ``solve_curtailment``
and the energy-limited-unit Monte Carlo on the card against the CPU, and
the multi-area, ELU and maintenance SEQ steps without a host sync; the
multilevel-splitting SEQ study's K = 1 reduction to the never-split
estimate and its step without a host sync, and the command line's
``nsq`` on the card.

Tests that need a card carry the ``gpu`` marker and skip without one.
The file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed, without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu_torch.core import (
    cases, load_profile)
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    dcopf, lp_ipm_batched, lp_ipm_structured)
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.ops import (
    batched_chol as bc, blocked_chol as bl, certify_kernel,
    fused_sampler_cert as ff, hw_sampler, ipm_fused)
from powersystemsreliabilityassessment_tpu_torch.sampling import chronological
from powersystemsreliabilityassessment_tpu_torch.studies import (
    hl2_nsq, hl2_seq)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _stressed_states(n, seed):
    """3x unavailability, three branch outages on every 32nd lane."""
    case = cases.rts24()
    u = twostate.unavailability(case)
    rng = np.random.default_rng(seed)
    down = rng.uniform(size=(n, case.n_comp)) < 3 * u[None, :]
    down[:, 14] = False
    for lane in range(0, n, 32):
        down[lane, case.n_gen + rng.choice(case.n_branch, 3,
                                           replace=False)] = True
    return down


def _lp_inputs(sys_, down):
    up = 1.0 - torch.as_tensor(down, device=sys_.device).float()
    gen_up, br_up = up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous()
    load = sys_.load_pd[None, :].expand(down.shape[0], sys_.n_load)
    c, b, l, u, cs = dcopf.build_state_lp_vectors(
        sys_, gen_up, br_up, load, CompatFlags(), IPMConfig().theta_max)
    return cs, br_up, c, b, l, u


def concentrated_300(case, n):
    """[n, n_comp] float32 deep contingencies of ``case300s``
    (tests/test_case300.py's recipe, its four lanes first): in area 2 i +
    1 (lanes 6-11: area 2 (i - 6)), the 9 + i largest of its 33 units and
    two of its lines go down, so the area's deficit exceeds its 1000 MW
    import and the shed is transmission-limited. Shared with
    tests/test_torch_case300.py (CPU)."""
    ng, nl = case.n_gen, case.n_branch
    states = np.zeros((n, ng + nl), np.float32)
    for i in range(n):
        a = 2 * i + 1 if i < 6 else 2 * (i - 6)
        gs = np.argsort(case.gen_pmax[a * 33:(a + 1) * 33])[-(9 + i):]
        states[i, a * 33 + gs] = 1.0
        states[i, ng + a * 38 + np.array([3 + i, 17])] = 1.0
    return states


def sampled_300(case, n, seed, branch_boost=1.0):
    """[n, n_comp] float32 ``case300s`` outage states drawn with numpy
    from the case's unavailabilities (the branches' times
    ``branch_boost``), the synchronous condensers pinned up as the NSQ
    sampler pins them. Shared with tests/test_torch_island_pf.py (CPU)."""
    u = twostate.unavailability(case).copy()
    u[case.n_gen:] = np.minimum(branch_boost * u[case.n_gen:], 0.5)
    rng = np.random.default_rng(seed)
    down = rng.uniform(size=(n, case.n_comp)) < u[None, :]
    down[:, :case.n_gen] &= ~case.sync_cond_mask[None, :]
    return down.astype(np.float32)


def golden_states(case, sys_):
    """scripts/golden_replay.py::build_state_set, in numpy: 40 stressed
    states, every N-1 branch outage, 12 N-2 pairs, 8 off-peak states."""
    rng = np.random.default_rng(2024)
    u = twostate.unavailability(case)
    nc, nl, ng = case.n_comp, case.n_branch, case.n_gen
    peak = sys_.load_pd.double().numpy()
    downs, loads, tags = [], [], []
    st = rng.uniform(size=(40, nc)) < 3 * u[None, :]
    st[:, 14] = False
    for i, s in enumerate(st):
        downs.append(s); loads.append(peak); tags.append(f"stress{i}")
    for k in range(nl):
        s = np.zeros(nc, bool); s[ng + k] = True
        downs.append(s); loads.append(peak); tags.append(f"N-1 line{k}")
    for i in range(12):
        k1, k2 = rng.choice(nl, 2, replace=False)
        s = np.zeros(nc, bool); s[ng + k1] = True; s[ng + k2] = True
        downs.append(s); loads.append(peak); tags.append(f"N-2 l{k1}+l{k2}")
    st2 = rng.uniform(size=(8, nc)) < 3 * u[None, :]
    st2[:, 14] = False
    for i, s in enumerate(st2):
        downs.append(s); loads.append(0.6 * peak); tags.append(f"offpeak{i}")
    return np.asarray(downs), np.asarray(loads, np.float32), tags


def check_golden_replay(device):
    """The 98 golden states through ``evaluate_states`` on ``device``,
    against tests/golden/golden_replay.json within 0.05 MW (the oracle
    tolerance of scripts/golden_replay.py:53, ORACLE_TOL_MW)."""
    golden = json.loads((ROOT / "tests" / "golden"
                         / "golden_replay.json").read_text())
    case = cases.rts24()
    sys_ = build_system(case, device=device)
    downs, loads, tags = golden_states(case,
                                       build_system(case, device="cpu"))
    assert tags == golden["tags"]
    res = dcopf.evaluate_states(sys_, torch.as_tensor(downs, device=device),
                                torch.as_tensor(loads, device=device))
    err = np.abs(res.dns_mw.double().cpu().numpy()
                 - np.asarray(golden["dns_mw"]))
    assert err.max() <= 0.05, (tags[int(err.argmax())], err.max())


@pytest.mark.gpu
def test_golden_replay_on_card(cuda):
    check_golden_replay(cuda)


@pytest.mark.gpu
def test_k2_kernels_match_plain(cuda):
    rng = np.random.default_rng(3)
    G = rng.normal(size=(256, 62, 66))
    M = G @ G.transpose(0, 2, 1)
    s = 1.0 / np.sqrt(np.einsum("bii->bi", M))
    M = M * s[:, :, None] * s[:, None, :] + 1e-7 * np.eye(62)
    M[0] = np.eye(62)
    M[0, 0, 1] = M[0, 1, 0] = 1.0005          # floored negative pivot
    M = torch.as_tensor(M, dtype=torch.float32, device=cuda)
    r = torch.as_tensor(rng.normal(size=(256, 62)), dtype=torch.float32,
                        device=cuda)
    before = dict(bc.launches)
    L_k, L_p = bc.cholesky(M), bc.cholesky_plain(M)
    x_k, x_p = bc.cho_solve(L_p, r), bc.cho_solve_plain(L_p, r)
    torch.cuda.synchronize()
    assert bc.launches["cholesky"] == before["cholesky"] + 1
    assert bc.launches["cho_solve"] == before["cho_solve"] + 1
    # Same algorithm in float32: rounding order and rsqrtf only.
    assert float((L_k - L_p).abs().max()) < 1e-4
    scale = torch.clamp_min(x_p.abs().amax(1, keepdim=True), 1.0)
    assert float(((x_k - x_p) / scale).abs().max()) < 1e-4
    assert float(L_k[0, 1, 1]) == pytest.approx(-1.0, abs=1e-3)


def _spd(batch, m, seed, device):
    """Equilibrated SPD matrices (unit diagonal plus the 1e-7 ridge) with
    condition numbers up to ~1e4, float32 on ``device``."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(batch, m, m + 4)) * rng.uniform(
        0.05, 1.0, size=(batch, 1, m + 4))
    M = G @ G.transpose(0, 2, 1)
    s = 1.0 / np.sqrt(np.einsum("bii->bi", M))
    M = M * s[:, :, None] * s[:, None, :] + 1e-7 * np.eye(m)
    return torch.as_tensor(M, dtype=torch.float32, device=device)


def _k2_check(M, r=None):
    """K2a (and K2b on the plain factor, with ``r``) against the plain
    versions: one launch a call, per-lane errors within chip_smoke.py's
    K2_L_BOUND (1e-4) and K2_X_BOUND (1e-3), zeros above the diagonal."""
    before = dict(bc.launches)
    L_k, L_p = bc.cholesky(M), bc.cholesky_plain(M)
    torch.cuda.synchronize()
    assert bc.launches["cholesky"] == before["cholesky"] + 1
    assert float(_lane_rel_err(L_k, L_p).max()) <= 1e-4
    assert bool((torch.triu(L_k, 1) == 0).all())
    if r is not None:
        x_k, x_p = bc.cho_solve(L_p, r), bc.cho_solve_plain(L_p, r)
        torch.cuda.synchronize()
        assert bc.launches["cho_solve"] == before["cho_solve"] + 1
        assert float(_lane_rel_err(x_k, x_p).max()) <= 1e-3
    return L_k


def _polish_matrices(sys_, down):
    """The equilibrated A A' polish_box_lp factors, on RTS-24 LP lanes."""
    st = ipm_fused.build_structure(sys_)
    cs, br_up, *_ = _lp_inputs(sys_, down)
    M = ipm_fused.normal_matrix(st, cs * cs, br_up)
    s = torch.rsqrt(torch.diagonal(M, dim1=1, dim2=2).clamp_min(1e-30))
    return (M * s[:, :, None] * s[:, None, :]
            + 1e-7 * torch.eye(st.m, device=M.device)).contiguous()


@pytest.mark.gpu
def test_k2_kernels_match_plain_at_the_path_shapes(cuda):
    # The RTS-24 polish's [256, 62, 62] and its solve [256, 62], and
    # RTS-96's diagonal panels [2048, 56, 56] and [2048, 23, 23].
    sys_ = build_system(cases.rts24(), device=cuda)
    M62 = _polish_matrices(sys_, _stressed_states(256, 31))
    gen = torch.Generator(device=cuda).manual_seed(4)
    _k2_check(M62, torch.randn((256, 62), generator=gen, device=cuda))
    M191, panels = rts96_normal_matrices(cuda), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bc, "cholesky",
                   lambda S: panels.append(S.clone()) or bc.cholesky_plain(S))
        bl._factor_once(M191)
    assert [p.shape[-1] for p in panels] == [56, 56, 56, 23]
    for P in (panels[0], panels[-1]):
        _k2_check(P.repeat(8, 1, 1).contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 3, 255, 257, 2049])
def test_k2_ragged_batches_match_plain(cuda, batch):
    M = _spd(batch, 62, batch, cuda)
    r = torch.randn((batch, 62), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(5))
    _k2_check(M, r)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 23, 56, 62, 64, 72])
def test_k2_at_every_row_slot_count_matches_plain(cuda, m):
    # One, two and three row slots a thread, and the edges between them.
    for batch in (256, 2048):
        M = _spd(batch, m, m, cuda)
        r = torch.randn((batch, m), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(m))
        _k2_check(M, r)


@pytest.mark.gpu
def test_k2_floored_and_nan_lanes_do_not_leak(cuda):
    # One 8-lane block (2,048 lanes: one warp a lane): a lane that hits
    # the pivot floor and a lane with a NaN beside good lanes.
    M = _spd(2048, 56, 8, cuda)
    assert bc.launch_shape(2048, 56, _sms())[:2] == (1, 8)
    M[1] = torch.eye(56, device=cuda)
    M[1, 0, 1] = M[1, 1, 0] = 1.0005
    M[2, 30, 20] = M[2, 20, 30] = float("nan")
    r = torch.randn((2048, 56), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(6))
    L = bc.cholesky(M)
    L_p = bc.cholesky_plain(M)
    x = bc.cho_solve(L_p, r)
    torch.cuda.synchronize()
    assert float(L[1, 1, 1]) == pytest.approx(-1.0, abs=1e-3)
    assert bool(torch.isfinite(L[1]).all())
    assert bool(torch.isnan(L[2]).any())
    assert torch.equal(torch.isnan(L[2]), torch.isnan(L_p[2]))
    good = [0] + list(range(3, 2048))
    assert bool(torch.isfinite(L[good]).all())
    assert bool(torch.isfinite(x[good]).all())
    assert float(_lane_rel_err(L[good], L_p[good]).max()) <= 1e-4
    assert float(_lane_rel_err(x[good], bc.cho_solve_plain(
        L_p[good], r[good])).max()) <= 1e-3


@pytest.mark.gpu
def test_k2_lanes_are_independent_of_batch_and_launch_shape(cuda):
    # A lane's factor depends on its matrix alone: the same bits alone, in
    # a batch, permuted, and on one, two or four warps.
    M = _spd(300, 62, 9, cuda)
    full = bc.cholesky(M)
    for i in (0, 1, 150, 299):
        assert torch.equal(bc.cholesky(M[i:i + 1].contiguous())[0], full[i])
    perm = torch.randperm(300, generator=torch.Generator().manual_seed(3))
    perm = perm.to(cuda)
    assert torch.equal(bc.cholesky(M[perm].contiguous()), full[perm])
    from powersystemsreliabilityassessment_tpu_torch.ops import cuda_build
    for wpl in bc.WARPS_PER_LANE:
        L = torch.empty_like(M)
        assert cuda_build.library().psra_cholesky(
            M.data_ptr(), L.data_ptr(), 300, 62,
            *bc.launch_shape(300, 62, _sms(), wpl),
            cuda_build.stream_handle(M)) == 0
        assert torch.equal(L, full)
    r = torch.randn((300, 62), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(7))
    x = bc.cho_solve(full, r)
    assert torch.equal(bc.cho_solve(full[7:8].contiguous(),
                                    r[7:8].contiguous())[0], x[7])
    assert torch.equal(bc.cho_solve(full[perm].contiguous(),
                                    r[perm].contiguous()), x[perm])


@pytest.mark.gpu
@pytest.mark.parametrize("m", [56, 62])
def test_k2a_takes_operands_off_16_byte_alignment(cuda, m):
    # The kernel moves M and L in 16-, 8- or 4-byte pieces by m and the
    # pointers' alignment: views one and two floats into their storage
    # take the narrower pieces and give the same bits.
    M = _spd(64, m, 12, cuda)
    want = bc.cholesky(M)
    for off in (1, 2):
        Mv = torch.empty(64 * m * m + off, device=cuda)[off:].view(64, m, m)
        Mv.copy_(M)
        assert torch.equal(bc.cholesky(Mv), want)


@pytest.mark.gpu
def test_k2a_refuses_a_shared_size_off_the_layout(cuda):
    from powersystemsreliabilityassessment_tpu_torch.ops import cuda_build
    M = _spd(64, 62, 10, cuda)
    L = torch.empty_like(M)
    wpl, lpb, smem = bc.launch_shape(64, 62, _sms())
    for shape in ((wpl, lpb, smem + 4), (3, 1, 4 * bc.lane_words(62, 3)),
                  (1, 9, 9 * 4 * bc.lane_words(62, 1))):
        err = cuda_build.library().psra_cholesky(
            M.data_ptr(), L.data_ptr(), 64, 62, *shape,
            cuda_build.stream_handle(M))
        assert err != 0


@pytest.mark.gpu
def test_k1_kernel_matches_plain(cuda):
    sys_ = build_system(cases.rts24(), device=cuda)
    st = ipm_fused.build_structure(sys_)
    args = _lp_inputs(sys_, _stressed_states(256, 11))
    before = ipm_fused.launches["fused_ipm_iterations"]
    ker = ipm_fused.fused_ipm_iterations(st, *args, IPMConfig())
    pla = ipm_fused.fused_ipm_iterations_plain(st, *args, IPMConfig())
    torch.cuda.synchronize()
    assert ipm_fused.launches["fused_ipm_iterations"] == before + 1
    assert all(bool(torch.isfinite(t).all()) for t in ker)
    assert float((ker[4] - pla[4]).abs().max()) < 1e-3
    sol = lp_ipm_structured.solve_box_lp_structured(st, *args, IPMConfig())
    assert float(sol.primal_residual.max()) < 2e-3


def edge_case(kind):
    """A case whose LP sits at an edge of K1's row range: "m72" is RTS-24
    with ten more branches (parallel to the first ten), nb + nl = 24 + 48
    = 72; "m14" a 6-bus ring with two chords, six units and three loads,
    nb + nl = 6 + 8 = 14 (one row slot, most threads of the warp idle).
    Shared with the CPU tests (tests/test_torch_ipm_lists.py)."""
    case = cases.rts24()
    if kind == "m72":
        more = {f: np.concatenate([getattr(case, f), getattr(case, f)[:10]])
                for f in ("br_from", "br_to", "br_x", "br_rate", "br_lambda",
                          "br_dur")}
        return dataclasses.replace(case, name="rts24_m72", **more)
    f64 = lambda *v: np.asarray(v, dtype=np.float64)
    i32 = lambda *v: np.asarray(v, dtype=np.int32)
    return cases.CaseData(
        name="ring6", base_mva=100.0,
        bus_pd=f64(0, 120, 0, 150, 0, 90), bus_qd=f64(0, 20, 0, 30, 0, 20),
        gen_bus=i32(0, 0, 2, 2, 4, 4), gen_pmax=f64(100, 60, 80, 50, 70, 40),
        gen_pmin=f64(0, 0, 0, 0, 0, 0),
        gen_mttf=f64(1100, 960, 1150, 1100, 960, 450),
        gen_mttr=f64(50, 40, 50, 50, 40, 50),
        gen_maint_weeks=f64(2, 2, 3, 3, 2, 2),
        br_from=i32(0, 1, 2, 3, 4, 5, 0, 1), br_to=i32(1, 2, 3, 4, 5, 0, 3, 4),
        br_x=f64(0.08, 0.1, 0.12, 0.09, 0.11, 0.1, 0.2, 0.18),
        br_rate=f64(120, 100, 110, 120, 100, 90, 80, 80),
        br_lambda=f64(0.4, 0.5, 0.4, 0.3, 0.5, 0.4, 0.6, 0.6),
        br_dur=f64(10, 12, 10, 11, 10, 12, 16, 16))


def edge_lp_inputs(kind, device, n=256, seed=17):
    """(structure, LP inputs) of ``n`` lanes of :func:`edge_case`:
    3x unavailability states, a branch outage on every fourth lane."""
    case = edge_case(kind)
    sys_ = build_system(case, device=device)
    rng = np.random.default_rng(seed)
    down = rng.uniform(size=(n, case.n_comp)) < \
        3 * twostate.unavailability(case)[None, :]
    down[:, sys_.always_up_nsq.cpu().numpy()] = False
    down[::4, case.n_gen + rng.integers(0, case.n_branch, (n + 3) // 4)] = True
    return ipm_fused.build_structure(sys_), _lp_inputs(sys_, down)


def _k1_check(st, args, cfg=IPMConfig(), x_init=None):
    """K1 against its plain version on the same lanes (both from
    ``x_init`` when given): every output finite, best_score within
    K1_SCORE_BOUND (1e-3), as chip_smoke.py's k1 phase holds it; the
    polished objective within 1e-3 p.u. (0.1 MW, K1_OBJ_BOUND) on all but
    one lane in a thousand and within 1e-2 p.u. on every lane. Both are
    float32 IPMs in another summation order; on a degenerate stressed
    lane the two iterates polished to objectives 1.8e-3 p.u. apart on an
    H100 (one of 2,048 stressed lanes)."""
    before = ipm_fused.launches["fused_ipm_iterations"]
    ker = ipm_fused.fused_ipm_iterations(st, *args, cfg, x_init=x_init)
    pla = ipm_fused.fused_ipm_iterations_plain(st, *args, cfg, x_init)
    torch.cuda.synchronize()
    assert ipm_fused.launches["fused_ipm_iterations"] == before + 1
    assert all(bool(torch.isfinite(t).all()) for t in ker)
    assert float((ker[4] - pla[4]).abs().max()) <= 1e-3
    obj = [lp_ipm_structured.polish_structured(st, s, *args, cfg).objective
           for s in (ker, pla)]
    diff = (obj[0] - obj[1]).abs()
    assert int((diff > 1e-3).sum()) <= diff.numel() // 1000
    assert float(diff.max()) <= 1e-2
    return ker


def _lane_rows(out, idx):
    return [t[idx] for t in out]


@pytest.mark.gpu
def test_k1_lanes_are_independent(cuda):
    # A lane's outputs are the same bits alone, in a batch of 256 and in
    # a permuted batch: no arithmetic crosses lanes, whatever the block
    # (1 and 256 lanes take the same instance, two warps a lane).
    sys_ = build_system(cases.rts24(), device=cuda)
    st = ipm_fused.build_structure(sys_)
    args = _lp_inputs(sys_, _stressed_states(256, 12))
    full = ipm_fused.fused_ipm_iterations(st, *args)
    perm = torch.randperm(256, generator=torch.Generator().manual_seed(3)
                          ).to(cuda)
    permuted = ipm_fused.fused_ipm_iterations(
        st, *(a[perm].contiguous() for a in args))
    inv = torch.argsort(perm)
    for a, b in zip(full, permuted):
        assert torch.equal(a, b[inv])
    for lane in (0, 5, 131, 255):
        alone = ipm_fused.fused_ipm_iterations(
            st, *(a[lane:lane + 1].contiguous() for a in args))
        for a, b in zip(_lane_rows(full, slice(lane, lane + 1)), alone):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_k1_mixed_lanes_in_one_block(cuda):
    # 2,048 lanes go four to a block: lanes 0-3 share one. Lane 1 is the
    # stressed lane with the plain version's largest best_score, lane 2
    # has a NaN lower bound (no finite iterate: it freezes at once with
    # best_score inf), lanes 0 and 3 have no outage and freeze early. The
    # others still equal, bit for bit, their runs among copies of
    # themselves (2,048 lanes again: the same instance, one warp a lane).
    sys_ = build_system(cases.rts24(), device=cuda)
    st = ipm_fused.build_structure(sys_)
    props = torch.cuda.get_device_properties(cuda)
    assert ipm_fused.launch_shape(st, 2048, props.multi_processor_count
                                  )[0] >= 4
    down = _stressed_states(2048, 13)
    args = list(_lp_inputs(sys_, down))
    pla = ipm_fused.fused_ipm_iterations_plain(
        st, *(a[:256] for a in args))
    hard = [a[int(torch.argmax(pla[4]))].clone() for a in args]
    calm = _lp_inputs(sys_, np.zeros((1, down.shape[1]), bool))
    for a, h, q in zip(args, hard, calm):
        a[0] = a[3] = q[0]
        a[1] = h
    args[4][2, 0] = float("nan")            # l of lane 2
    out = ipm_fused.fused_ipm_iterations(st, *args)
    assert not bool(torch.isfinite(out[4][2]))  # no finite score for it
    for lane in (0, 1, 3):
        alone = ipm_fused.fused_ipm_iterations(
            st, *(a[lane].expand_as(a).contiguous() for a in args))
        for a, b in zip(_lane_rows(out, slice(lane, lane + 1)),
                        _lane_rows(alone, slice(0, 1))):
            assert torch.equal(a, b)
    assert bool(torch.isfinite(out[4][3:]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 3, 255, 257, 2048])
def test_k1_ragged_batches_match_plain(cuda, batch):
    sys_ = build_system(cases.rts24(), device=cuda)
    _k1_check(ipm_fused.build_structure(sys_),
              _lp_inputs(sys_, _stressed_states(batch, 14)))


def _warm_start(st, args, frac=0.02):
    """The warm rescue's first start point: the polished solution of a
    cold solve, clamped ``frac`` of the box width inside."""
    l, u = args[4], args[5]
    cold = lp_ipm_structured.polish_structured(
        st, ipm_fused.fused_ipm_iterations_plain(st, *args), *args)
    return torch.clamp(cold.x, l + frac * (u - l), u - frac * (u - l))


@pytest.mark.gpu
def test_k1_from_a_start_point_matches_plain(cuda):
    # The warm rescue's launch: RESCUE_LANES lanes (two warps a lane)
    # from the rescue's first start point.
    sys_ = build_system(cases.rts24(), device=cuda)
    st = ipm_fused.build_structure(sys_)
    args = _lp_inputs(sys_, _stressed_states(
        lp_ipm_structured.RESCUE_LANES, 15))
    _k1_check(st, args, x_init=_warm_start(st, args))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [16, 2048])
def test_k1_null_start_is_the_box_midpoint(cuda, batch):
    # No start point and the box midpoint passed as one give the same
    # bits, at both instances' shapes.
    sys_ = build_system(cases.rts24(), device=cuda)
    st = ipm_fused.build_structure(sys_)
    args = _lp_inputs(sys_, _stressed_states(batch, 16))
    cold = ipm_fused.fused_ipm_iterations(st, *args)
    mid = ipm_fused.fused_ipm_iterations(
        st, *args, x_init=0.5 * (args[4] + args[5]))
    for a, b in zip(cold, mid):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ipm_fused.fused_ipm_iterations(st, *args, x_init=args[4][:, 1:])
    with pytest.raises(ValueError):
        ipm_fused.fused_ipm_iterations(st, *args, x_init=args[4].cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["m72", "m14"])
def test_k1_at_the_edges_of_m_matches_plain(cuda, kind):
    st, args = edge_lp_inputs(kind, cuda)
    assert st.m == int(kind[1:])
    _k1_check(st, args)


@pytest.mark.gpu
def test_kernel_wrappers_reject_bad_operands(cuda):
    M = torch.eye(62, device=cuda).repeat(4, 1, 1)
    with pytest.raises(ValueError, match="float32"):
        bc.cholesky(M.double())
    with pytest.raises(ValueError, match="contiguous"):
        bc.cholesky(M.transpose(1, 2))
    with pytest.raises(ValueError, match="m <= 72"):
        bc.cholesky(torch.eye(80, device=cuda).repeat(2, 1, 1))


@pytest.mark.gpu
def test_screened_evaluation_on_card_matches_cpu(cuda):
    down = _stressed_states(4096, 23)
    out = {}
    for dev in ("cpu", cuda):
        sys_ = build_system(cases.rts24(), device=dev)
        load = sys_.load_pd[None, :].expand(down.shape[0], sys_.n_load)
        res, over = dcopf.evaluate_states_screened(
            sys_, torch.as_tensor(down, device=dev), load, 256,
            nodal_mode="proportional",
            repair_buffer=dcopf.default_repair_buffer(4096))
        out[str(dev)] = (res.dns_mw.cpu().numpy(), res.failure.cpu().numpy(),
                         int(over))
    (d_cpu, f_cpu, o_cpu), (d_gpu, f_gpu, o_gpu) = out.values()
    assert o_cpu == o_gpu == 0
    assert np.abs(d_gpu - d_cpu).max() <= 0.05   # ORACLE_TOL_MW
    assert (f_gpu == f_cpu).mean() >= 0.999


@pytest.mark.gpu
def test_batch_step_never_waits_for_the_device(cuda):
    sys_ = build_system(cases.rts24(), device=cuda)
    step = hl2_nsq.make_nsq_batch_step(
        sys_, 8192, CompatFlags(), IPMConfig(), max_lp=256,
        nodal_mode="proportional",
        shed_hint=np.full(sys_.n_load, 1.0 / sys_.n_load, np.float32))
    step(hl2_nsq.batch_generator(0, 0, cuda))      # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m, n_over, n_infeas = step(hl2_nsq.batch_generator(0, 1, cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(m.n) == 8192 and int(n_over) == 0


@pytest.mark.gpu
def test_small_study_on_card(cuda):
    ref = json.loads((ROOT / "results" / "nsq_results.json").read_text())
    before = ipm_fused.launches["fused_ipm_iterations"]
    res = hl2_nsq.run_nsq_study(
        cases.rts24(), MCSConfig(batch_size=4096, max_samples=16384),
        device=cuda, log_every=0)
    assert ipm_fused.launches["fused_ipm_iterations"] > before
    se_e = math.hypot(ref["beta"] * ref["edns_mw"], res.beta * res.edns_mw)
    assert abs(res.edns_mw - ref["edns_mw"]) <= 4 * se_e
    se_p = math.hypot(
        math.sqrt(ref["plc"] * (1 - ref["plc"]) / ref["samples"]),
        math.sqrt(res.plc * (1 - res.plc) / res.samples))
    assert abs(res.plc - ref["plc"]) <= 4 * se_p


def rts96_normal_matrices(device, n=256):
    """Equilibrated normal matrices of ``n`` real RTS-96 LP lanes (3x
    unavailability states, numpy seed 96) as the IPM factors them: half
    at the fourth iteration's barrier weights, half of the polish's
    A A'. Shared with tests/test_torch_blocked_chol.py (CPU)."""
    case = cases.rts96()
    sys_ = build_system(case, device=device)
    rng = np.random.default_rng(96)
    down = rng.uniform(size=(n, case.n_comp)) < \
        3 * twostate.unavailability(case)[None, :]
    down[:, sys_.always_up_nsq.cpu().numpy()] = False
    up = 1.0 - torch.as_tensor(down, device=device).float()
    load = sys_.load_pd[None, :].expand(n, sys_.n_load)
    lp = dcopf.build_state_lp(
        sys_, up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous(), load,
        CompatFlags(), IPMConfig().theta_max)
    kernels = lp_ipm_batched._BLOCKED_KERNELS
    mats = []

    def capture(M):
        mats.append(M.clone())
        return kernels.factor(M)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lp_ipm_batched, "_BLOCKED_KERNELS",
                   kernels._replace(factor=capture))
        lp_ipm_batched.solve_box_lp_batched(*lp, IPMConfig(iterations=4))
    return torch.cat([mats[3][:n // 2], mats[4][n // 2:]]).contiguous()


def _lane_rel_err(a, b):
    lane = lambda t: t.abs().flatten(1).amax(1)
    return lane(a - b) / lane(b).clamp_min(1.0)


@pytest.mark.gpu
def test_k3_kernels_match_plain(cuda):
    M = rts96_normal_matrices(cuda)
    P = bl.PANEL
    S = M[:, :P, :P]
    lift = bl.LIFT * torch.diagonal(S, dim1=1, dim2=2).clamp_min(1e-30)
    L0 = bc.cholesky((S + torch.diag_embed(lift)).contiguous())
    B56 = M[:, P:2 * P, :P].transpose(1, 2).contiguous()   # block (1, 0)
    B23 = M[:, 3 * P:, :P].transpose(1, 2).contiguous()    # block (3, 0)
    r1 = torch.randn((M.shape[0], P, 1), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(1))
    # The last, 23-wide diagonal panel's factor (RTS-96's m = 191 splits
    # 56 + 56 + 56 + 23), as the blocked factor builds it.
    L23 = bl._factor_once(M)[1][-1]
    assert L23.shape[1:] == (23, 23)
    r23 = r1[:, :23].contiguous()
    before = dict(bl.launches)
    for fn, plain, L, rhs in ((bl.trsm_fwd, bl.trsm_fwd_plain, L0, B56),
                              (bl.trsm_fwd, bl.trsm_fwd_plain, L0, B23),
                              (bl.trsm_fwd, bl.trsm_fwd_plain, L0, r1),
                              (bl.trsm_bwd, bl.trsm_bwd_plain, L0, r1),
                              (bl.trsm_fwd, bl.trsm_fwd_plain, L23, r23),
                              (bl.trsm_bwd, bl.trsm_bwd_plain, L23, r23)):
        got, want = fn(L, rhs), plain(L, rhs)
        torch.cuda.synchronize()
        # Same substitution in float32 in another summation order;
        # chip_smoke.py's K3_BOUND states the 1e-3 per-lane bound.
        assert float(_lane_rel_err(got, want).max()) <= 1e-3
    assert bl.launches["trsm_fwd"] == before["trsm_fwd"] + 4
    assert bl.launches["trsm_bwd"] == before["trsm_bwd"] + 2
    with pytest.raises(ValueError, match="contiguous"):
        bl.trsm_fwd(L0.transpose(1, 2), r1)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 7, 23, 56, 64])
@pytest.mark.parametrize("batch", [1, 2047])
def test_k3_kernels_match_plain_at_edges(cuda, batch, p):
    # batch 2047 is not a multiple of the lanes a block takes; P = 56
    # takes the unrolled instances, the rest the generic ones; K = 23 and
    # 56 pack several lanes into a block, K = 65 one. NaN above the
    # diagonal: the kernel may read only the lower triangle.
    gen = torch.Generator(device=cuda).manual_seed(batch + p)
    G = torch.randn((batch, p, p), generator=gen, device=cuda)
    eye = torch.eye(p, device=cuda)
    L = (torch.linalg.cholesky(G @ G.transpose(1, 2) / p + eye)
         + torch.full_like(eye, float("nan")).triu(1)).contiguous()
    before = dict(bl.launches)
    for k in (1, 23, 56, 65):
        rhs = torch.randn((batch, p, k), generator=gen, device=cuda)
        for fn, plain in ((bl.trsm_fwd, bl.trsm_fwd_plain),
                          (bl.trsm_bwd, bl.trsm_bwd_plain)):
            got, want = fn(L, rhs), plain(L, rhs)
            torch.cuda.synchronize()
            err = _lane_rel_err(got, want)
            assert bool(torch.isfinite(err).all())
            assert float(err.max()) <= 1e-3          # K3_BOUND
    assert bl.launches["trsm_fwd"] == before["trsm_fwd"] + 4
    assert bl.launches["trsm_bwd"] == before["trsm_bwd"] + 4


@pytest.mark.gpu
def test_blocked_route_on_card_matches_plain(cuda, monkeypatch):
    M = rts96_normal_matrices(cuda)
    r = torch.randn((M.shape[0], M.shape[1]), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    before = dict(bl.launches)
    x_k = bl.blocked_cho_solve(bl.blocked_cholesky(M), r)
    assert bl.launches["trsm_fwd"] > before["trsm_fwd"]
    with monkeypatch.context() as mp:
        mp.setattr(bc, "cholesky", bc.cholesky_plain)
        mp.setattr(bl, "trsm_fwd", bl.trsm_fwd_plain)
        mp.setattr(bl, "trsm_bwd", bl.trsm_bwd_plain)
        x_p = bl.blocked_cho_solve(bl.blocked_cholesky(M), r)
    ev = torch.linalg.eigvalsh(M.double())
    cond = ev[:, -1] / ev[:, 0].clamp_min(1e-300)
    # Each refined float32 solve lands within ~cond eps of the exact one
    # (chip_smoke.py, BLOCKED_X_*): 4 cond eps per lane, 1e-3 floor; a
    # lane whose probe sits on the rescue threshold may split (<= 1%).
    tol = (4 * cond * 2.0 ** -24).clamp_min(1e-3)
    over = _lane_rel_err(x_k, x_p).double() > tol
    assert int(over.sum()) <= 0.01 * M.shape[0]


@pytest.mark.gpu
def test_rts96_step_launches_k2_and_k3(cuda):
    sys_ = build_system(cases.rts96(), device=cuda)
    assert sys_.n_bus + sys_.n_branch == 191
    step = hl2_nsq.make_nsq_batch_step(sys_, 8192, CompatFlags(),
                                       IPMConfig(), nodal_mode="lp")
    before = {**bc.launches, **bl.launches}
    m, n_over, _ = step(hl2_nsq.batch_generator(0, 0, cuda))
    assert float(m.n) == 8192 and int(n_over) == 0
    assert bool(torch.isfinite(m.sum_dns))
    after = {**bc.launches, **bl.launches}
    for name in ("cholesky", "trsm_fwd", "trsm_bwd"):
        assert after[name] > before[name], name


def case300_schur_panels(sys_, n=8):
    """The diagonal panels K2a factors in the first block-Schur factor of
    ``n`` concentrated case300s lanes at the box-midpoint start's barrier
    weights: K's five [n, 56, 56] and one [n, 20, 20] (nb = 300), then
    S's."""
    states = concentrated_300(cases.case300s(), n)
    up = 1.0 - torch.as_tensor(states, device=sys_.device)
    ng = sys_.n_gen
    load = sys_.load_pd[None, :].expand(n, sys_.n_load)
    c, b, l, u, cs = dcopf.build_state_lp_vectors(
        sys_, up[:, :ng], up[:, ng:].contiguous(), load, CompatFlags(),
        IPMConfig().theta_max)
    ops = dcopf.make_dc_linops(sys_, cs[:, :ng], up[:, ng:].contiguous())
    x = 0.5 * (l + u)
    d = 1.0 / (x - l) + 1.0 / (u - x)
    panels = []
    factor = bc.cholesky

    def capture(S):
        panels.append(S.clone())
        return factor(S)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bc, "cholesky", capture)
        ops.schur_factor(1.0 / d, 0.0, IPMConfig().regularization)
    return panels


@pytest.mark.gpu
def test_k2a_and_k3_at_the_schur_shapes_match_plain(cuda):
    sys_ = build_system(cases.case300s(), device=cuda)
    panels = case300_schur_panels(sys_)
    assert [p.shape[-1] for p in panels] == [56] * 5 + [20] + [56] * 5 + [20]
    for S in (panels[4], panels[5], panels[10], panels[11]):
        for batch in (S.shape[0], 2048):
            M = S.repeat(batch // S.shape[0], 1, 1).contiguous()
            L = _k2_check(M)
            P = M.shape[-1]
            eye = torch.eye(P, device=cuda).expand(batch, P, P).contiguous()
            before = bl.launches["trsm_fwd"]
            got, want = bl.trsm_fwd(L, eye), bl.trsm_fwd_plain(L, eye)
            torch.cuda.synchronize()
            assert bl.launches["trsm_fwd"] == before + 1
            # chip_smoke.py's K3_BOUND.
            assert float(_lane_rel_err(got, want).max()) <= 1e-3


@pytest.mark.gpu
def test_case300_evaluate_states_on_card(cuda):
    """Eight concentrated deep contingencies of case300s through
    evaluate_states on the card: the Schur bulk pass launches K2a and K3,
    and no lane trips the evaluator's 5e-3 guard."""
    sys_ = build_system(cases.case300s(), device=cuda)
    down = torch.as_tensor(concentrated_300(cases.case300s(), 8),
                           device=cuda).bool()
    load = sys_.load_pd[None, :].expand(8, sys_.n_load)
    before = {**bc.launches, **bl.launches}
    res = dcopf.evaluate_states(sys_, down, load)
    cert = dcopf.certify_states(sys_, down, load).certified
    tripped = int(((res.primal_residual > 5e-3) & ~cert).sum())
    assert tripped == 0
    assert bool(torch.isfinite(res.dns_mw).all())
    assert float(res.dns_mw.min()) > 600.0     # transmission-limited shed
    for name, d in (("cholesky", bc.launches), ("trsm_fwd", bl.launches)):
        assert d[name] > before[name]


@pytest.mark.gpu
def test_island_pf_on_card_matches_cpu(cuda):
    """Tier 1.5 (certify_island_pf) on the card against the same function
    on CPU tensors, on the tier-1 misses of case300s lanes drawn at 8x
    branch unavailability (islanding and deep multi-branch states): the
    same certified mask, the bound within 1e-4 p.u., and no host sync."""
    case = cases.case300s()
    down = torch.as_tensor(sampled_300(case, 1024, seed=12, branch_boost=8.0))
    sys_cpu, sys_gpu = (build_system(case, device=d) for d in ("cpu", cuda))
    load = sys_cpu.load_pd[None, :].expand(down.shape[0], sys_cpu.n_load)
    miss = ~dcopf.certify_states(sys_cpu, down, load, woodbury_k=4).certified
    d = down[miss][:256]
    assert d.shape[0] >= 64
    want = dcopf.certify_island_pf(sys_cpu, d, load[:d.shape[0]])
    d_gpu = d.to(cuda)
    load_gpu = sys_gpu.load_pd[None, :].expand(d.shape[0], sys_gpu.n_load)
    dcopf.certify_island_pf(sys_gpu, d_gpu, load_gpu)     # first call: warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dcopf.certify_island_pf(sys_gpu, d_gpu, load_gpu)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(want.certified.sum()) >= 32
    np.testing.assert_array_equal(got.certified.cpu().numpy(),
                                  want.certified.numpy())
    assert float((got.deficit.cpu() - want.deficit).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_k6_kernel_is_bit_equal_to_plain(cuda):
    sys_ = build_system(cases.rts24(), device=cuda)
    thresh = hw_sampler.bernoulli_thresholds(sys_.unavail, sys_.always_up_nsq)
    before = hw_sampler.launches["sample_states_hw"]
    for seed in (0, 1):
        gen = hl2_nsq.batch_generator(seed, 0, cuda)
        got = hw_sampler.sample_states_hw(gen, sys_.unavail,
                                          sys_.always_up_nsq, 65536)
        seeds = hw_sampler.seed_words(hl2_nsq.batch_generator(seed, 0, cuda),
                                      cuda)
        assert torch.equal(got, hw_sampler.sample_states_hw_plain(
            seeds, thresh, 65536))
        assert not got[:, 14].any()
    assert hw_sampler.launches["sample_states_hw"] == before + 2


def _boosted(sys_, n, seed, boost):
    gen = torch.Generator(device=sys_.device).manual_seed(seed)
    p = torch.clamp(sys_.unavail * boost, max=0.5)
    u = torch.rand((n, sys_.n_comp), generator=gen, device=sys_.device)
    return (u < p) & ~sys_.always_up_nsq


@pytest.mark.gpu
def test_k4_kernel_matches_plain_in_both_modes(cuda):
    sys_ = build_system(cases.rts24(), device=cuda)
    hint = torch.full((sys_.n_load,), 1.0 / sys_.n_load, device=cuda)
    B = 32768
    before = ff.launches["sample_certify_quick"]
    got = ff.sample_certify_quick(hl2_nsq.batch_generator(0, 3, cuda), sys_,
                                  B, shed_hint=hint)
    seeds = hw_sampler.seed_words(hl2_nsq.batch_generator(0, 3, cuda), cuda)
    thresh = hw_sampler.bernoulli_thresholds(sys_.unavail, sys_.always_up_nsq)
    want = ff.sample_certify_quick_plain(sys_, B, seeds, thresh, hint=hint)
    assert torch.equal(got[0], want[0])            # K6's states
    boosted = _boosted(sys_, B, 4, 40.0)
    got_e = ff.sample_certify_quick(None, sys_, B, down=boosted)
    want_e = ff.sample_certify_quick_plain(sys_, B, down=boosted,
                                           hint=ff.hint_row(sys_, None))
    torch.cuda.synchronize()
    assert ff.launches["sample_certify_quick"] == before + 2
    load = sys_.load_pd[None, :].expand(B, sys_.n_load)
    for (d, ok1, deficit, shed), (_, ok_p, def_p, shed_p) in (
            (got, want), (got_e, want_e)):
        # Same float32 arithmetic in another summation order.
        assert float((ok1 == ok_p).float().mean()) >= 0.999
        assert float((deficit - def_p).abs().max()) <= 1e-5
        assert float((shed - shed_p).abs().max()) <= 1e-5
        cert = dcopf.certify_states(sys_, d, load)
        assert bool((~ok1 | cert.certified).all())   # the band is sound
    # The band's arithmetic, at the reference's wider 2^-14 where, under
    # the calibrated hint, it routes lanes (6-8% in both modes; the
    # port's own band routes almost none).
    wide = 2.0 ** -14
    hint = torch.as_tensor(dcopf.calibrate_shed_hint(sys_), device=cuda)
    ops = ff.kernel_operands(sys_, hint)
    for dn, ok_k in (
            (got[0], ff.launch(sys_, B, seeds, None, ops, eps=wide)[1]),
            (boosted, ff.launch(sys_, B, None, boosted, ops, eps=wide)[1])):
        ok_p = ff.sample_certify_quick_plain(sys_, B, down=dn, hint=hint,
                                             eps=wide)[1]
        first = dcopf.certify_states(
            sys_, dn, load, shed_hint=hint[None, :].expand(B, sys_.n_load),
            repair_iters=0).certified & (dn[:, sys_.n_gen:].sum(1) <= 1)
        assert float((ok_k == ok_p).float().mean()) >= 0.999
        assert float((first & ~ok_k).float().mean()) > 0.01   # routed


def k4_limit_case(n_bus=120, n_units=8):
    """A ring of ``n_bus`` buses with a 10 MW load at each and
    ``n_units`` 200 MW units spread around it: 128 components, and every
    dimension of K4 near its limit of 128. At 128 lanes a block its LODF
    does not fit beside PTDF and the lanes and is read through the cache;
    at 32 it is staged (``ops/fused_sampler_cert.py::launch_shape``).
    Shared with the CPU tests (tests/test_torch_k4_plan.py)."""
    f64 = lambda v: np.asarray(v, dtype=np.float64)
    i32 = lambda v: np.asarray(v, dtype=np.int32)
    bus = np.arange(n_bus)
    full = lambda n, v: f64(np.full(n, v))
    return cases.CaseData(
        name="ring120", base_mva=100.0, bus_pd=full(n_bus, 10.0),
        bus_qd=full(n_bus, 2.0), gen_bus=i32(bus[::n_bus // n_units]),
        gen_pmax=full(n_units, 200.0), gen_pmin=full(n_units, 0.0),
        gen_mttf=full(n_units, 1000.0), gen_mttr=full(n_units, 50.0),
        gen_maint_weeks=full(n_units, 2.0), br_from=i32(bus),
        br_to=i32((bus + 1) % n_bus), br_x=f64(0.05 + 0.05 * (bus % 3)),
        br_rate=full(n_bus, 80.0), br_lambda=full(n_bus, 0.5),
        br_dur=full(n_bus, 10.0))


def _k4_vs_plain(sys_, batch, seeds=None, down=None, hint=None):
    """K4 (one launch on packed operands) and its plain version on the
    same inputs, held to the k4 phase's bounds of chip_smoke.py: states
    bit for bit, deficit and shed within 1e-5 p.u. (float32 sums in
    another order), first-pass masks on >= 99.9% of lanes, none outside
    certify_states' certified set. Returns (kernel, plain) outputs."""
    hint = ff.hint_row(sys_, None) if hint is None else hint
    ops = ff.kernel_operands(sys_, hint)
    before = ff.launches["sample_certify_quick"]
    got = ff.launch(sys_, batch, seeds, down, ops)
    want = ff.sample_certify_quick_plain(sys_, batch, seeds, ops[2], down,
                                         hint)
    load = sys_.load_pd[None, :].expand(batch, sys_.n_load)
    cert = dcopf.certify_states(sys_, got[0], load, shed_hint=hint[None, :]
                                .expand(batch, sys_.n_load))
    torch.cuda.synchronize()
    assert ff.launches["sample_certify_quick"] == before + 1
    assert torch.equal(got[0], want[0])
    assert float((got[1] == want[1]).float().mean()) >= 0.999
    assert float((got[2] - want[2]).abs().max()) <= 1e-5
    assert float((got[3] - want[3]).abs().max()) <= 1e-5
    assert bool((~got[1] | cert.certified).all())
    return got, want


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 127, 129, 8192, 262145])
def test_k4_ragged_batches_match_plain(cuda, batch):
    # Partial warps and blocks, one-warp blocks (8,192) and 128-lane
    # blocks with a ragged last tile (262,145).
    sys_ = build_system(cases.rts24(), device=cuda)
    seeds = hw_sampler.seed_words(hl2_nsq.batch_generator(1, batch, cuda),
                                  cuda)
    got, _ = _k4_vs_plain(sys_, batch, seeds=seeds)
    assert got[1].any()


@pytest.mark.gpu
def test_k4_lanes_are_independent(cuda):
    # A lane's outputs depend on its row alone: not on the batch, the
    # launch shape it implies, or its neighbours.
    sys_ = build_system(cases.rts24(), device=cuda)
    ops = ff.kernel_operands(sys_, ff.hint_row(sys_, None))
    B = 1000
    down = _boosted(sys_, B, 8, 40.0)
    full = ff.launch(sys_, B, None, down, ops)
    for i in (0, 1, 517, 999):
        alone = ff.launch(sys_, 1, None, down[i:i + 1].contiguous(), ops)
        for a, b in zip(alone, full):
            assert torch.equal(a[0], b[i])
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(3))
    perm = perm.to(cuda)
    shuffled = ff.launch(sys_, B, None, down[perm].contiguous(), ops)
    for a, b in zip(shuffled, full):
        assert torch.equal(a, b[perm])
    # Random mode: row r draws the same states, so gives the same
    # outputs, in a batch of 300 (one-warp blocks) as in 262,144 (128).
    seeds = hw_sampler.seed_words(hl2_nsq.batch_generator(0, 2, cuda), cuda)
    small = ff.launch(sys_, 300, seeds, None, ops)
    big = ff.launch(sys_, 262144, seeds, None, ops)
    for a, b in zip(small, big):
        assert torch.equal(a, b[:300])


@pytest.mark.gpu
def test_k4_mixed_lanes_in_one_block(cuda):
    # One 32-lane block: intact lanes, single outages (the islanding
    # branch among them: LODF sentinel 1e6), two and three outages, every
    # unit down, and stressed unit outages.
    sys_ = build_system(cases.rts24(), device=cuda)
    ng, nl, B = sys_.n_gen, sys_.n_branch, 32
    assert ff.launch_shape(ng, sys_.n_load, nl, sys_.n_bus, B,
                           _sms())[0] == B
    island = int(torch.nonzero((sys_.lodf == 1e6).any(0)).flatten()[0])
    down = torch.zeros((B, sys_.n_comp), dtype=torch.bool, device=cuda)
    for lane, ks in enumerate([(0,), (island,), (5,), (17,), (nl - 1,),
                               (island, 3), (2, 9), (4, 20, 31)]):
        down[6 + lane, [ng + k for k in ks]] = True
    down[14, :ng] = True
    down[15:] = _boosted(sys_, B - 15, 9, 40.0)
    down[:, sys_.always_up_nsq] = False
    got, want = _k4_vs_plain(sys_, B, down=down)
    assert torch.equal(got[1], want[1])
    n_out = down[:, ng:].sum(1)
    assert not got[1][n_out >= 2].any()
    assert not bool(got[1][7])                     # the islanding outage
    load = sys_.load_pd.float()
    assert float((got[2][14] - load.sum()).abs()) <= 1e-5
    assert float((got[3][14] - load).abs().max()) <= 1e-5
    assert got[1][:6].all()                        # intact, no deficit


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [8192, 32768])
def test_k4_at_the_dimension_limit_matches_plain(cuda, batch):
    sys_ = build_system(k4_limit_case(), device=cuda)
    assert ff.supported(sys_) and sys_.n_comp == 128
    lanes, stage, _ = ff.launch_shape(sys_.n_gen, sys_.n_load,
                                      sys_.n_branch, sys_.n_bus, batch,
                                      _sms())
    # LODF staged with 32 lanes a block, read through the cache with 128.
    assert bool(stage & certify_kernel.STAGE_LODF) == (lanes == 32)
    seeds = hw_sampler.seed_words(hl2_nsq.batch_generator(2, 0, cuda), cuda)
    got, _ = _k4_vs_plain(sys_, batch, seeds=seeds)
    assert got[1].any() and not got[1].all()


@pytest.mark.gpu
def test_k4_refuses_a_shared_size_off_the_plan(cuda):
    # The launcher reads the lanes a block from the shared bytes: a size
    # off the plan, or PTDF left out, is an error, never a guess.
    from powersystemsreliabilityassessment_tpu_torch.ops import cuda_build
    sys_ = build_system(cases.rts24(), device=cuda)
    fbuf, ibuf, thresh = ff.kernel_operands(sys_, ff.hint_row(sys_, None))
    dims = (sys_.n_gen, sys_.n_load, sys_.n_branch, sys_.n_bus)
    lanes, stage, smem = ff.launch_shape(*dims, 4096, _sms())
    seeds = hw_sampler.seed_words(hl2_nsq.batch_generator(0, 0, cuda), cuda)
    out = (torch.empty((64, sys_.n_comp), dtype=torch.bool, device=cuda),
           torch.empty(64, dtype=torch.bool, device=cuda),
           torch.empty(64, device=cuda),
           torch.empty((64, sys_.n_load), device=cuda))
    for st, sm in ((stage, smem + 4), (stage & ~certify_kernel.STAGE_PTDF,
                                        smem)):
        err = cuda_build.library().psra_fused_sampler_cert(
            seeds.data_ptr(), thresh.data_ptr(), None, fbuf.data_ptr(),
            ibuf.data_ptr(), 64, *dims, st, sm, ff.guard_eps(sys_),
            *(t.data_ptr() for t in out), cuda_build.stream_handle(fbuf))
        assert err != 0


@pytest.mark.gpu
@pytest.mark.parametrize("case,boost,tol", [("rts24", 40.0, 1e-5),
                                           ("rts96", 10.0, 1e-4)])
def test_k5_kernel_matches_plain(cuda, case, boost, tol):
    sys_ = build_system(getattr(cases, case)(), device=cuda)
    B = 8192
    down = _boosted(sys_, B, 6, boost)
    load = sys_.load_pd[None, :].expand(B, sys_.n_load)
    before = certify_kernel.launches["certify_states_fused"]
    got = certify_kernel.certify_states_fused(sys_, down, load)
    want = dcopf.certify_states(sys_, down, load, woodbury_k=2)
    torch.cuda.synchronize()
    assert certify_kernel.launches["certify_states_fused"] == before + 1
    assert float((got.certified == want.certified).float().mean()) >= 0.999
    # RTS-96's ~90 p.u. capacity sums: atol = rtol = 1e-4, as the
    # reference's own test (tests/test_certify_kernel.py:112).
    rtol = 0.0 if case == "rts24" else tol
    excess = (got.deficit - want.deficit).abs() - rtol * want.deficit.abs()
    assert float(excess.max()) <= tol
    both = got.certified & want.certified
    for a, b in ((got.shed, want.shed), (got.dispatch, want.dispatch)):
        assert float((a - b).abs()[both].max()) <= 1e-4


def _k5_vs_plain(sys_, down, load, repair_iters=3, tol=1e-5, rtol=0.0):
    """K5 (one launch) against certify_states(woodbury_k=2) on the same
    states and loads, held to the k5 phase's bounds of chip_smoke.py:
    masks on >= 99.9% of lanes (float32 sums in another order: flow
    checks bind at zero margin on deficit optima), deficits within
    ``tol`` + ``rtol`` |deficit|, shed and dispatch within 1e-4 p.u. on
    lanes both certify. Returns (kernel outputs, plain Certificate)."""
    ops = certify_kernel.kernel_operands(sys_)
    before = certify_kernel.launches["certify_states_fused"]
    got = certify_kernel.launch(sys_, down, load, repair_iters, ops)
    want = dcopf.certify_states(sys_, down, load, repair_iters=repair_iters,
                                woodbury_k=2)
    torch.cuda.synchronize()
    assert certify_kernel.launches["certify_states_fused"] == before + 1
    assert float((got[0] == want.certified).float().mean()) >= 0.999
    excess = (got[1] - want.deficit).abs() - rtol * want.deficit.abs()
    assert float(excess.nan_to_num(0.0).max()) <= tol
    both = got[0] & want.certified
    for a, b in ((got[2], want.shed), (got[3], want.dispatch)):
        assert float((a - b).abs()[both].max()) <= 1e-4
    return got, want


def _varied_load(sys_, n, seed):
    """Per-lane loads: the peak row scaled by 0.7-1.3 per entry."""
    g = torch.Generator(device=sys_.device).manual_seed(seed)
    scale = 0.7 + 0.6 * torch.rand((n, sys_.n_load), generator=g,
                                   device=sys_.device)
    return sys_.load_pd[None, :] * scale


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 31, 33, 127, 129, 8192, 262145])
def test_k5_ragged_batches_match_plain(cuda, batch):
    # Partial warps and tiles, split lanes (small batches) and 128-lane
    # tiles with a ragged last one (262,145), per-lane loads.
    sys_ = build_system(cases.rts24(), device=cuda)
    down = _boosted(sys_, batch, 11, 20.0)
    got, _ = _k5_vs_plain(sys_, down, _varied_load(sys_, batch, 12))
    if batch > 100:
        assert got[0].any() and not got[0].all()


@pytest.mark.gpu
@pytest.mark.parametrize("repair_iters", [0, 1, 2, 3])
def test_k5_repair_iters_match_plain(cuda, repair_iters):
    # Loads at 1.1x peak: many lanes fail the first check and repair.
    sys_ = build_system(cases.rts24(), device=cuda)
    B = 32768
    down = sample_states_default(sys_, B, 3)
    load = sys_.load_pd[None, :].expand(B, sys_.n_load) * 1.1
    got, want = _k5_vs_plain(sys_, down, load, repair_iters, tol=2e-5)
    first = dcopf.certify_states(sys_, down, load, repair_iters=0,
                                 woodbury_k=2).certified
    repaired = int((want.certified & ~first).sum())
    assert (repaired == 0) == (repair_iters == 0)


def sample_states_default(sys_, n, seed):
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    return sample_states(hl2_nsq.batch_generator(seed, 0, sys_.device),
                         sys_.unavail, sys_.always_up_nsq, n)


@pytest.mark.gpu
def test_k5_lanes_are_independent(cuda):
    # A lane's outputs depend on its state and load alone: not on the
    # batch, its neighbours, the order or the launch shape the batch
    # implies (40,000 lanes: one thread a lane, 128 a block; 16,384: two;
    # 8,000: four; 3,000 and one lane: eight), nor on how many lanes the
    # repair took together.
    sys_ = build_system(cases.rts24(), device=cuda)
    ops = certify_kernel.kernel_operands(sys_)
    B = 40000
    down = _boosted(sys_, B, 8, 40.0)
    load = _varied_load(sys_, B, 9)
    full = certify_kernel.launch(sys_, down, load, 3, ops)
    same = lambda a, b: torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    splits = set()
    for n in (16384, 8000, 3000):
        part = certify_kernel.launch(sys_, down[:n].contiguous(),
                                     load[:n].contiguous(), 3, ops)
        for a, b in zip(part, full):
            assert same(a, b[:n]), n
    for n in (B, 16384, 8000, 3000):
        splits.add(certify_kernel.launch_shape(
            sys_.n_gen, sys_.n_load, sys_.n_branch, sys_.n_bus, n,
            _sms())[1] >> certify_kernel.SPLIT_SHIFT & 3)
    assert splits == {0, 1, 2, 3}                  # 1, 2, 4 and 8 threads
    for i in (0, 1, 517, 39999):
        alone = certify_kernel.launch(sys_, down[i:i + 1].contiguous(),
                                      load[i:i + 1].contiguous(), 3, ops)
        for a, b in zip(alone, full):
            assert same(a[0], b[i])
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(3))
    perm = perm.to(cuda)
    shuffled = certify_kernel.launch(sys_, down[perm].contiguous(),
                                     load[perm].contiguous(), 3, ops)
    for a, b in zip(shuffled, full):
        assert same(a, b[perm])


@pytest.mark.gpu
def test_k5_mixed_lanes_in_one_block(cuda):
    # One 32-lane block: intact lanes, single outages (the islanding
    # branch among them: LODF sentinel 1e6), two and three outages, every
    # unit down, stressed unit outages, and a NaN load row that stays in
    # its own lane.
    sys_ = build_system(cases.rts24(), device=cuda)
    ng, nl, B = sys_.n_gen, sys_.n_branch, 32
    island = int(torch.nonzero((sys_.lodf == 1e6).any(0)).flatten()[0])
    down = torch.zeros((B, sys_.n_comp), dtype=torch.bool, device=cuda)
    for lane, ks in enumerate([(0,), (island,), (5,), (17,), (nl - 1,),
                               (island, 3), (2, 9), (4, 20, 31)]):
        down[6 + lane, [ng + k for k in ks]] = True
    down[14, :ng] = True
    down[15:] = _boosted(sys_, B - 15, 9, 40.0)
    down[:, sys_.always_up_nsq] = False
    load = sys_.load_pd[None, :].repeat(B, 1)
    load[20] = float("nan")
    assert certify_kernel.launch_shape(ng, sys_.n_load, nl, sys_.n_bus, B,
                                       _sms())[0] == B
    got, want = _k5_vs_plain(sys_, down, load)
    assert torch.equal(got[0], want.certified)
    n_out = down[:, ng:].sum(1)
    assert not got[0][n_out >= 3].any()
    assert not bool(got[0][20]) and bool(torch.isnan(got[1][20]))
    ok = torch.ones(B, dtype=torch.bool, device=cuda)
    ok[20] = False
    for t in got[1:]:                              # the NaN stays in lane 20
        assert bool(torch.isfinite(t[ok]).all())
    assert float((got[1][14] - sys_.load_pd.float().sum()).abs()) <= 1e-5
    assert got[0][:6].all()                        # intact, no deficit


@pytest.mark.gpu
def test_k5_at_the_dimension_limit_matches_plain(cuda):
    # The 120-bus ring: every dimension near 128, an even load count
    # (the load rows take a padded stride), LODF and the transfer matrix
    # through L2 at 128 lanes a block.
    sys_ = build_system(k4_limit_case(), device=cuda)
    B = 32768
    lanes, stage, _ = certify_kernel.launch_shape(
        sys_.n_gen, sys_.n_load, sys_.n_branch, sys_.n_bus, B, _sms())
    assert not stage & certify_kernel.STAGE_LODF and sys_.n_load % 2 == 0
    down = _boosted(sys_, B, 2, 4.0)
    load = sys_.load_pd[None, :].expand(B, sys_.n_load)
    # The deficit sums 120 loads of 0.1 p.u. in another order than the
    # plain version: RTS-96's absolute bound (1e-4) for sums this long.
    got, _ = _k5_vs_plain(sys_, down, load, tol=1e-4)
    assert got[0].any() and not got[0].all()


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [8192, 65536])
def test_k5_rts96_reads_lodf_through_l2(cuda, batch):
    sys_ = build_system(cases.rts96(), device=cuda)
    _, stage, _ = certify_kernel.launch_shape(
        sys_.n_gen, sys_.n_load, sys_.n_branch, sys_.n_bus, batch, _sms())
    assert not stage & (certify_kernel.STAGE_LODF
                        | certify_kernel.STAGE_TRANSFER)
    down = _boosted(sys_, batch, 6, 10.0)
    load = sys_.load_pd[None, :].expand(batch, sys_.n_load)
    got, _ = _k5_vs_plain(sys_, down, load, tol=1e-4, rtol=1e-4)
    assert got[0].any()


@pytest.mark.gpu
def test_k5_refuses_a_shared_size_off_the_plan(cuda):
    from powersystemsreliabilityassessment_tpu_torch.ops import cuda_build
    sys_ = build_system(cases.rts24(), device=cuda)
    fbuf, ibuf = certify_kernel.kernel_operands(sys_)
    dims = (sys_.n_gen, sys_.n_load, sys_.n_branch, sys_.n_bus)
    _, stage, smem = certify_kernel.launch_shape(*dims, 4096, _sms())
    B = 64
    down = torch.zeros((B, sys_.n_comp), dtype=torch.bool, device=cuda)
    load = sys_.load_pd[None, :].repeat(B, 1).contiguous()
    out = (torch.empty(B, dtype=torch.bool, device=cuda),
           torch.empty(B, device=cuda),
           torch.empty((B, sys_.n_load), device=cuda),
           torch.empty((B, sys_.n_gen), device=cuda))
    work = torch.empty(B + 1, dtype=torch.int32, device=cuda)
    other = 1 << certify_kernel.LANES_SHIFT         # 64 lanes a block
    for st, sm in ((stage, smem + 4),
                   (stage & ~certify_kernel.STAGE_PTDF, smem),
                   ((stage & ~(3 << certify_kernel.LANES_SHIFT)) | other,
                    smem)):
        err = cuda_build.library().psra_certify(
            down.data_ptr(), load.data_ptr(), fbuf.data_ptr(),
            ibuf.data_ptr(), B, *dims, 3, st, sm, work.data_ptr(),
            *(t.data_ptr() for t in out), cuda_build.stream_handle(fbuf))
        assert err != 0


@pytest.mark.gpu
@pytest.mark.parametrize("n_comp", [1, 5, 71, 128])
@pytest.mark.parametrize("batch", [1, 3, 255, 257, 262145])
def test_k6_ragged_shapes_are_bit_equal_to_plain(cuda, batch, n_comp):
    rng = np.random.default_rng(n_comp)
    thresh = torch.as_tensor(rng.integers(0, 1 << 23, n_comp),
                             dtype=torch.int32, device=cuda)
    thresh[0] = 0                                  # a pinned component
    seeds = torch.tensor([12345, -67890], dtype=torch.int32, device=cuda)
    got = hw_sampler.launch(seeds, thresh, batch)
    want = hw_sampler.sample_states_hw_plain(seeds, thresh, batch)
    assert torch.equal(got, want)
    assert not got[:, 0].any()


@pytest.mark.gpu
def test_fused_step_never_waits_for_the_device(cuda):
    sys_ = build_system(cases.rts24(), device=cuda)
    step = hl2_nsq.make_nsq_batch_step(
        sys_, 8192, CompatFlags(), IPMConfig(), max_lp=256,
        nodal_mode="proportional", fused_tier1=True,
        shed_hint=np.full(sys_.n_load, 1.0 / sys_.n_load, np.float32))
    step(hl2_nsq.batch_generator(0, 0, cuda))      # builds the kernels
    torch.cuda.synchronize()
    before = ff.launches["sample_certify_quick"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        m, n_over, n_infeas = step(hl2_nsq.batch_generator(0, 1, cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ff.launches["sample_certify_quick"] == before + 1
    assert float(m.n) == 8192 and int(n_over) == 0
    assert bool(torch.isfinite(m.sum_dns))


# -- the SEQ study's shapes: 16 years x 256 LP lanes a year -------------------

SEQ_LANES = 4096


def seq_lp_inputs(sys_, n_lanes=SEQ_LANES, seed=11):
    """Structured LP inputs of ``n_lanes`` real SEQ LP lanes: hour-states
    of the port's own 16-year blocks at the study's load profile that the
    certificate leaves uncertified or with a deficit (the lanes
    ``hl2_seq.evaluate_years`` sends to the LP in "lp" nodal mode)."""
    years, hours = 16, 8736
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    load = hl2_seq.year_block_load(sys_, load_profile.load_factors(hours),
                                   years)
    downs, loads, got, block = [], [], 0, 0
    while got < n_lanes:
        flat = hl2_seq.sample_years(
            hl2_nsq.batch_generator(seed, block, sys_.device), sys_, years,
            hours, k).transpose(1, 2).reshape(years * hours, -1)
        cert = dcopf.certify_states(sys_, flat, load,
                                    repair_buffer=years * hours // 16)
        idx = torch.nonzero((~cert.certified) | (cert.deficit > 0)).flatten()
        downs.append(flat[idx])
        loads.append(load[idx])
        got += idx.numel()
        block += 1
    down, load = torch.cat(downs)[:n_lanes], torch.cat(loads)[:n_lanes]
    up = 1.0 - down.float()
    gen_up, br_up = up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous()
    c, b, l, u, cs = dcopf.build_state_lp_vectors(
        sys_, gen_up, br_up, load, CompatFlags(), IPMConfig().theta_max)
    return cs, br_up, c, b, l, u


# The screened evaluator keeps an LP lane's answer only where its quality
# (primal residual + 2 n duality gap) is within this (engines/dcopf.py
# _finalize); elsewhere it takes the certificate's bound.
LP_QUALITY_GUARD = 5e-3


def _lp_optimum(st, args, lane):
    """Float64 optimum (HiGHS) of one structured LP lane."""
    from scipy.optimize import linprog
    colscale, br_up, c, b, l, u = args
    A = ipm_fused.mv(st, colscale[lane].expand(st.n, -1),
                     br_up[lane].expand(st.n, -1),
                     torch.eye(st.n, device=c.device)).T
    f64 = lambda t: t.double().cpu().numpy()
    r = linprog(f64(c[lane]), A_eq=f64(A), b_eq=f64(b[lane]),
                bounds=list(zip(f64(l[lane]), f64(u[lane]))), method="highs")
    assert r.success
    return r.fun


@pytest.mark.gpu
def test_k1_at_the_seq_buffer_matches_plain(cuda):
    # 4,096 lanes: one warp a lane and more blocks than one wave. Where
    # the evaluator keeps both answers, K1 equals its plain version within
    # chip_smoke.py's K1_OBJ_BOUND and K1_SCORE_BOUND (1e-3). Some SEQ
    # lanes are LPs neither float32 IPM solves in 16 iterations (~5% fail
    # the guard on both paths); where one side fails it and the objectives
    # differ by more than 1e-3, the kernel is within the guard's 5e-3 of
    # the float64 optimum, or no farther from it than the plain version.
    sys_ = build_system(cases.rts24(), device=cuda)
    st = ipm_fused.build_structure(sys_)
    assert ipm_fused.launch_shape(st, SEQ_LANES, _sms())[1] == 1
    args = seq_lp_inputs(sys_)
    before = ipm_fused.launches["fused_ipm_iterations"]
    ker = ipm_fused.fused_ipm_iterations(st, *args)
    pla = ipm_fused.fused_ipm_iterations_plain(st, *args)
    torch.cuda.synchronize()
    assert ipm_fused.launches["fused_ipm_iterations"] == before + 1
    assert all(bool(torch.isfinite(t).all()) for t in ker)
    sol = [lp_ipm_structured.polish_structured(st, v, *args)
           for v in (ker, pla)]
    q = [s_.primal_residual + 2 * st.n * s_.duality_gap for s_ in sol]
    kept = (q[0] <= LP_QUALITY_GUARD) & (q[1] <= LP_QUALITY_GUARD)
    assert int(kept.sum()) >= 0.9 * SEQ_LANES
    diff = (sol[0].objective - sol[1].objective).abs()
    assert float(diff[kept].max()) <= 1e-3
    assert float((ker[4] - pla[4]).abs()[kept].max()) <= 1e-3
    for lane in torch.nonzero(~kept & (diff > 1e-3)).flatten().tolist():
        opt = _lp_optimum(st, args, lane)
        assert abs(float(sol[0].objective[lane]) - opt) <= max(
            abs(float(sol[1].objective[lane]) - opt), LP_QUALITY_GUARD), lane


@pytest.mark.gpu
def test_k1_lane_alone_equals_it_in_the_seq_batch(cuda):
    # A lane's bits in the 4,096-lane batch equal its bits among 4,096
    # copies of itself and in a permuted batch (the same instance).
    sys_ = build_system(cases.rts24(), device=cuda)
    st = ipm_fused.build_structure(sys_)
    args = seq_lp_inputs(sys_)
    full = ipm_fused.fused_ipm_iterations(st, *args)
    perm = torch.randperm(SEQ_LANES, generator=torch.Generator(
        ).manual_seed(5)).to(cuda)
    permuted = ipm_fused.fused_ipm_iterations(
        st, *(a[perm].contiguous() for a in args))
    inv = torch.argsort(perm)
    for a, b in zip(full, permuted):
        assert torch.equal(a, b[inv])
    for lane in (0, 2047, 2048, SEQ_LANES - 1):
        alone = ipm_fused.fused_ipm_iterations(
            st, *(a[lane].expand_as(a).contiguous() for a in args))
        for a, b in zip(_lane_rows(full, slice(lane, lane + 1)),
                        _lane_rows(alone, slice(0, 1))):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_k2_at_the_seq_polish_shape_matches_plain(cuda, monkeypatch):
    # [4096, 62, 62] on one warp a lane, and the solve [4096, 62], on the
    # two matrices the polish factors for K1's iterates (A A' and
    # A W^-1 A' + I), captured on the path.
    sys_ = build_system(cases.rts24(), device=cuda)
    assert bc.launch_shape(SEQ_LANES, 62, _sms())[0] == 1
    st = ipm_fused.build_structure(sys_)
    args = seq_lp_inputs(sys_)
    kernels, mats = lp_ipm_batched._DIRECT_KERNELS["cuda"], []
    monkeypatch.setitem(lp_ipm_batched._DIRECT_KERNELS, "cuda",
                        kernels._replace(factor=lambda M: mats.append(
                            M.clone()) or kernels.factor(M)))
    lp_ipm_structured.polish_structured(
        st, ipm_fused.fused_ipm_iterations(st, *args), *args)
    assert [M.shape for M in mats] == [(SEQ_LANES, 62, 62)] * 2
    gen = torch.Generator(device=cuda).manual_seed(8)
    for M in mats:
        _k2_check(M, torch.randn((SEQ_LANES, 62), generator=gen,
                                 device=cuda))


@pytest.mark.gpu
def test_seq_step_never_waits_for_the_device(cuda):
    sys_ = build_system(cases.rts24(), device=cuda)
    hours = 8736
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    step = hl2_seq.make_seq_batch_step(
        sys_, 16, CompatFlags(), IPMConfig(), hours, k, 256,
        load_profile.load_factors(hours))
    step(hl2_nsq.batch_generator(0, 0, cuda))      # builds the kernels
    torch.cuda.synchronize()
    before = dict(ipm_fused.launches, **bc.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(hl2_nsq.batch_generator(0, 1, cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ens, plc, nlc, dlc = out[:4]
    assert ens.shape == (16,) and bool(torch.isfinite(ens).all())
    assert int(out[8]) == 0 and bool((dlc <= hours).all())
    # K1 and the polish (two factors, three solves), then the warm
    # rescue: K1 once for each float of rescue_stages and one more polish.
    warm = sum(f is not None for f in IPMConfig().rescue_stages)
    assert ipm_fused.launches["fused_ipm_iterations"] == \
        before["fused_ipm_iterations"] + 1 + warm
    assert bc.launches["cholesky"] == before["cholesky"] + 2 * 2
    assert bc.launches["cho_solve"] == before["cho_solve"] + 3 * 2


def _sampler_draws(kind, sys_, masks, gen, batch):
    """(down, weight or None) of one NSQ sampler option on ``sys_``."""
    from powersystemsreliabilityassessment_tpu_torch.sampling import state
    u, up = sys_.unavail, sys_.always_up_nsq
    comp = torch.arange(sys_.n_comp, device=sys_.device)
    if kind == "antithetic":
        return state.sample_states(gen, u, up, batch, antithetic=True), None
    if kind == "mixture":
        return state.sample_states_mixture(
            gen, u, up, batch, torch.as_tensor(masks, device=sys_.device),
            2.0, 0.5)
    mask = {"gens": comp < sys_.n_gen, "branches": comp >= sys_.n_gen}
    q = None
    if kind == "override":
        q = torch.clamp(u * 8.0, max=0.3)
    return state.sample_states_importance(gen, u, up, batch, 3.0,
                                          boost_mask=mask.get(kind),
                                          q_override=q)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["antithetic", "all", "gens", "branches",
                                  "override", "mixture"])
def test_samplers_on_card_match_cpu_marginals(cuda, kind):
    # The card's and the CPU's generators draw different streams, so the
    # samplers are held to their law: each component's failure share
    # within 4 combined standard errors of the CPU's, finite weights of
    # mean 1 (E_q[w] = 1) within 4 standard errors on both devices, and
    # the mixture's weights within 1 / alpha0.
    case = cases.rts96() if kind == "mixture" else cases.rts24()
    masks = hl2_nsq.gen_area_masks(case)
    B = 1 << 18
    freq = []
    for dev in (cuda, torch.device("cpu")):
        sys_ = build_system(case, device=dev)
        down, w = _sampler_draws(kind, sys_, masks,
                                 hl2_nsq.batch_generator(3, 1, dev), B)
        assert down.shape == (B, sys_.n_comp) and down.device.type == dev.type
        freq.append(down.double().mean(0).cpu().numpy())
        if w is not None:
            w = w.double().cpu().numpy()
            assert np.all(np.isfinite(w)) and np.all(w > 0)
            assert abs(w.mean() - 1.0) <= 4 * w.std() / math.sqrt(B) + 1e-12
            if kind == "mixture":
                assert w.max() <= 2.0 * (1 + 1e-6)
    p = (freq[0] + freq[1]) / 2
    se = np.sqrt(2 * p * (1 - p) / B)
    assert np.all(np.abs(freq[0] - freq[1]) <= 4 * se + 1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("option", ["boost", "antithetic", "is_q", "mix"])
def test_sampler_step_never_waits_for_the_device(cuda, option):
    # RTS-24 "lp" mode, batch 8,192: the boosted step's default buffer is
    # 4,096 LP lanes, the shape K1 runs at in the SEQ study.
    sys_ = build_system(cases.rts24(), device=cuda)
    kw = {"boost": dict(is_boost=2.0), "antithetic": dict(antithetic=True),
          "is_q": dict(is_q=np.where(np.arange(sys_.n_comp) >= sys_.n_gen,
                                     4.0, 1.0) * sys_.unavail.cpu().numpy()),
          "mix": dict(mix=(np.arange(sys_.n_comp)[None, :]
                           % 2 == np.array([[0], [1]]), 2.0, 0.5))}[option]
    step = hl2_nsq.make_nsq_batch_step(
        sys_, 8192, CompatFlags(), IPMConfig(), max_lp=4096,
        shed_hint=dcopf.calibrate_shed_hint(sys_), **kw)
    step(hl2_nsq.batch_generator(0, 0, cuda))      # builds the kernels
    torch.cuda.synchronize()
    before = ipm_fused.launches["fused_ipm_iterations"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        m, n_over, _ = step(hl2_nsq.batch_generator(0, 1, cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ipm_fused.launches["fused_ipm_iterations"] > before
    assert float(m.n) == 8192 and int(n_over) == 0
    assert math.isfinite(float(m.sum_dns)) and float(m.sum_dns) > 0


@pytest.mark.gpu
def test_copt_on_card_matches_host_float64(cuda):
    from powersystemsreliabilityassessment_tpu_torch.engines import copt
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl1_rts24)
    gens = hl1_rts24.rts24_fleet()
    caps = np.asarray([g.capacity for g in gens], np.float32)
    fors = np.asarray([g.for_rate for g in gens], np.float32)
    n = copt.grid_points_for(float(caps.sum()), 1.0)
    got = copt.build_copt(torch.as_tensor(caps), torch.as_tensor(fors), 1.0,
                          n, device=cuda)
    want = copt.build_copt_np(caps.astype(np.float64),
                              fors.astype(np.float64), 1.0)
    assert got.is_cuda and got.shape == want.shape
    assert np.abs(got.cpu().numpy() - want).max() <= 1e-6
    load = hl1_rts24.rts24_load()
    on_card = copt.lole_eue(got, 1.0, float(caps.sum()),
                            torch.as_tensor(load, device=cuda))
    on_cpu = copt.lole_eue(got.cpu(), 1.0, float(caps.sum()),
                           torch.as_tensor(load))
    for a, b in zip(on_card, on_cpu):
        assert float(a) == pytest.approx(float(b), rel=1e-5)
    assert float(on_card[0]) == pytest.approx(9.394095, rel=1e-4)


@pytest.mark.gpu
def test_enumeration_on_card_matches_cpu(cuda):
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        enumeration)
    out = {}
    for dev in ("cpu", cuda):
        sys_ = build_system(cases.rts24(), device=dev)
        step = enumeration.make_chunk_step(sys_, CompatFlags(), IPMConfig(),
                                           "lp", 2048, 2048)
        free = enumeration.free_components(
            sys_.unavail.cpu().numpy(), sys_.always_up_nsq.cpu().numpy())
        combos = enumeration.unrank_combinations(
            np.arange(5000, 7048, dtype=np.int64), 3, len(free))
        down = torch.zeros((2048, sys_.n_comp), dtype=torch.bool)
        down[np.repeat(np.arange(2048), 3), free[combos].ravel()] = True
        v = step(down.to(dev)).cpu().numpy()
        ex = enumeration.enumerate_exact(sys_, CompatFlags(), IPMConfig(),
                                         "lp", 2, chunk=4096)
        out[str(dev)] = v, ex
    (v_cpu, ex_cpu), (v_gpu, ex_gpu) = out.values()
    assert v_cpu[3, 0] == v_gpu[3, 0] == 0              # no overflow
    assert np.abs(v_gpu[0] - v_cpu[0]).max() <= 0.05    # DNS, MW
    assert (v_gpu[1] == v_cpu[1]).mean() >= 0.999        # failure flags
    assert ex_gpu.n_states == ex_cpu.n_states == 2486
    assert ex_gpu.mass == ex_cpu.mass
    assert ex_gpu.edns_mw == pytest.approx(ex_cpu.edns_mw, abs=1e-3)
    assert ex_gpu.pfail == pytest.approx(ex_cpu.pfail, abs=1e-6)


@pytest.mark.gpu
def test_blackout_batch_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(21)
    sys_cpu = build_system(cases.rts24(), device="cpu")
    u = sys_cpu.unavail.numpy().astype(np.float64).copy()
    u[sys_cpu.n_gen:] = 0.08
    down = rng.uniform(size=(4096, sys_cpu.n_comp)) < u[None, :]
    down &= ~sys_cpu.always_up_nsq.numpy()[None, :]
    compat = CompatFlags(island_blackout=True)
    out = []
    for dev in ("cpu", cuda):
        sys_ = build_system(cases.rts24(), device=dev)
        load = sys_.load_pd[None, :].expand(4096, sys_.n_load)
        d = torch.as_tensor(down, device=dev)
        reach = dcopf.connected_to_ref(sys_, 1.0 - d[:, sys_.n_gen:].float())
        res, n_over = dcopf.evaluate_states_screened(
            sys_, d, load, 4096, compat, IPMConfig(), "lp")
        out.append((reach.cpu().numpy(), res.dns_mw.cpu().numpy(),
                    res.failure.cpu().numpy(), int(n_over),
                    ~(res.primal_residual <= 5e-3).cpu().numpy()))
    (r_c, d_c, f_c, o_c, g_c), (r_g, d_g, f_g, o_g, g_g) = out
    np.testing.assert_array_equal(r_g, r_c)
    assert (~r_c.all(1)).sum() > 100                     # islanded lanes
    assert o_c == o_g == 0
    # The deep LP lanes of this batch are where K1 and its plain version
    # part (ROADMAP.md Queue 3 A and B): all but 0.1% of lanes agree
    # within 0.05 MW. On those that do not, the float64 optimum of the
    # lane's LP (after the blackout transform) judges the card: within
    # the guard's 5e-3 p.u. (0.5 MW) of it, unless the card's guard
    # flagged the lane and took the certificate's bound.
    diff = np.abs(d_g - d_c)
    assert (diff > 0.05).mean() <= 1e-3
    far = np.nonzero(diff > 0.05)[0]
    sys_ = build_system(cases.rts24(), device=cuda)
    d = torch.as_tensor(down[far], device=cuda)
    d, load, _ = dcopf.apply_island_blackout(
        sys_, d, sys_.load_pd[None, :].expand(far.size, sys_.n_load))
    up = 1.0 - d.float()
    c, b, l, u_, colscale = dcopf.build_state_lp_vectors(
        sys_, up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous(), load,
        compat, IPMConfig().theta_max)
    st = ipm_fused.build_structure(sys_)
    args = (colscale, up[:, sys_.n_gen:].contiguous(), c, b, l, u_)
    opt = np.asarray([_lp_optimum(st, args, j) for j in range(far.size)])
    off = (np.abs(d_g[far] - opt * sys_.base_mva)
           > LP_QUALITY_GUARD * sys_.base_mva)
    assert not (off & ~g_g[far]).any(), (far, d_c[far], d_g[far], opt)
    assert abs(float(d_g.mean()) - float(d_c.mean())) <= 0.01
    assert (f_g == f_c).mean() >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("option", ["cv", "enum", "blackout"])
def test_nsq_option_step_never_waits_for_the_device(cuda, option):
    case = cases.rts24()
    compat = CompatFlags(island_blackout=option == "blackout")
    sys_ = build_system(case, compat, device=cuda)
    kw = {"cv": dict(cv_arrays=(np.asarray(case.gen_pmax, np.float32),
                                float(case.bus_pd.sum()), 14.69, 0.0846)),
          "enum": dict(enum_order=4), "blackout": {}}[option]
    step = hl2_nsq.make_nsq_batch_step(
        sys_, 8192, compat, IPMConfig(), max_lp=2048,
        shed_hint=dcopf.calibrate_shed_hint(sys_), **kw)
    step(hl2_nsq.batch_generator(0, 0, cuda))      # builds the kernels
    torch.cuda.synchronize()
    before = ipm_fused.launches["fused_ipm_iterations"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        m, n_over, _ = step(hl2_nsq.batch_generator(0, 1, cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ipm_fused.launches["fused_ipm_iterations"] > before
    assert float(m.n) == 8192 and int(n_over) == 0
    assert math.isfinite(float(m.sum_dns))


@pytest.mark.gpu
@pytest.mark.parametrize("option", ["cv", "blackout", "maint"])
def test_seq_option_step_never_waits_for_the_device(cuda, option):
    case = cases.rts24()
    compat = CompatFlags(island_blackout=option == "blackout")
    sys_ = build_system(case, compat, device=cuda)
    hours = 8736
    factors = load_profile.load_factors(hours)
    mt = twostate.mean_times(case)
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    cv = None
    if option == "cv":
        loads = (factors * float(case.bus_pd.sum())).astype(np.float32)
        cv = (loads, np.asarray(case.gen_pmax, np.float32))
    maint = (hl2_seq.maintenance_down(case, hours) if option == "maint"
             else None)
    step = hl2_seq.make_seq_batch_step(
        sys_, 16, compat, IPMConfig(), hours, k, 256, factors,
        stationary=option == "cv", cv_arrays=cv, maint_down=maint)
    step(hl2_nsq.batch_generator(0, 0, cuda))      # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(hl2_nsq.batch_generator(0, 1, cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(out) == (12 if option == "cv" else 10)
    assert bool(torch.isfinite(out[0]).all()) and int(out[8]) == 0


# -- the multi-area LP's K2 shapes, ELU and multi-area on the card ---------

MULTI_LANES = 70080          # 8 years x 8,760 hours of the two-area demo


def _spd_batch(B, m, seed):
    """``B`` random equilibrated SPD m x m matrices (unit diagonal)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn((B, m, m + 2), generator=gen, device="cuda")
    M = G @ G.transpose(1, 2) / (m + 2) + 0.05 * torch.eye(m, device="cuda")
    s = torch.rsqrt(torch.diagonal(M, dim1=1, dim2=2))
    return (M * s[:, :, None] * s[:, None, :]).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_k2_at_the_multiarea_shapes_matches_plain(cuda, m):
    # One warp a lane, eight lanes a block; the row clamps, the one-slot
    # instance and the 2- / 1-float staging below m = 4 never ran on the
    # RTS paths (m >= 20).
    assert bc.launch_shape(MULTI_LANES, m, _sms())[:2] == (1, 8)
    M = _spd_batch(MULTI_LANES, m, seed=m)
    r = torch.randn((MULTI_LANES, m), generator=torch.Generator(
        device=cuda).manual_seed(100 + m), device=cuda)
    _k2_check(M, r)
    for B in (1, 7, 9, 1025):          # ragged batches around a block
        _k2_check(M[:B].contiguous(), r[:B].contiguous())


def _demo_margins(device, years=2, seed=0):
    """The two-area demo's margins [years x 8,760, 2] from the port's own
    draw on ``device``, and the system."""
    from powersystemsreliabilityassessment_tpu_torch.engines import multiarea
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        multiarea_demo)
    sys_ = multiarea_demo.demo_system()
    areas = multiarea.device_areas(sys_, device)
    down = multiarea.draw_block(areas, years,
                                hl2_nsq.batch_generator(seed, 0, device))
    return multiarea.block_margins(down, areas.caps, areas.load), sys_


@pytest.mark.gpu
def test_solve_curtailment_on_card_matches_cpu(cuda, monkeypatch):
    from powersystemsreliabilityassessment_tpu_torch.engines import multiarea
    margins, sys_ = _demo_margins(cuda)
    ties = (sys_.tie_from, sys_.tie_to, sys_.tie_cap.astype(np.float32))
    kernels, mats = lp_ipm_batched._DIRECT_KERNELS["cuda"], []
    monkeypatch.setitem(lp_ipm_batched._DIRECT_KERNELS, "cuda",
                        kernels._replace(factor=lambda M: mats.append(
                            M.clone()) or kernels.factor(M)))
    before = dict(bc.launches)
    got = multiarea.solve_curtailment(margins, *ties)
    torch.cuda.synchronize()
    assert bc.launches["cholesky"] > before["cholesky"]
    assert bc.launches["cho_solve"] > before["cho_solve"]
    want = multiarea.solve_curtailment(margins.cpu(), *ties)
    got = got.cpu()
    # Totals within 1e-3 MW, areas within 0.1 MW; a loss hour only one
    # side counts is float32 noise of the closed-form repair.
    assert float((got.sum(1) - want.sum(1)).abs().max()) <= 1e-3
    assert float((got - want).abs().max()) <= 0.1
    apart = (got > 0) != (want > 0)
    assert bool((torch.maximum(got, want)[apart] <= 1e-3).all())
    assert bool((got <= torch.clamp_min(-margins.cpu(), 0) + 1e-3).all())
    # The path's own normal matrices [B, 2, 2] through K2a against plain.
    assert mats and all(M.shape == (margins.shape[0], 2, 2) for M in mats)
    for M in mats[:3] + mats[-2:]:
        _k2_check(M)


@pytest.mark.gpu
def test_multiarea_step_never_waits_for_the_device(cuda):
    from powersystemsreliabilityassessment_tpu_torch.engines import multiarea
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        multiarea_demo)
    step = multiarea.make_multiarea_batch_step(
        multiarea_demo.demo_system(), 8, multiarea.INTERCONNECTED,
        IPMConfig(iterations=20), device=cuda)
    step(hl2_nsq.batch_generator(5, 0, cuda))     # builds the kernels
    torch.cuda.synchronize()
    before = dict(bc.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, eue = step(hl2_nsq.batch_generator(5, 1, cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert loss.shape == eue.shape == (2,)
    assert bool(torch.isfinite(eue).all()) and int(loss[1]) > 0
    # 20 iterations of a factor and two solves, then the polish's two
    # factors and three solves.
    assert bc.launches["cholesky"] - before["cholesky"] == 22
    assert bc.launches["cho_solve"] - before["cho_solve"] == 43


def _elu_inputs(cuda, years, hydro_hours=50.0):
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        elu, planning)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        planning_elu)
    fleet = planning_elu.demo_planning_fleet(hydro_hours)
    load = planning_elu.demo_planning_load()
    planning.schedule_maintenance(fleet, planning_elu.weekly_peaks_of(load))
    u, z = elu.elu_draws(hl2_nsq.batch_generator(4, 0, cuda), years,
                         len(load), fleet.n, cuda)
    args = (fleet.capacity, fleet.for_rate, fleet.maint_start,
            fleet.maint_weeks, fleet.energy_limit, load)
    return u, z, args, float(load.max()) * 0.05


@pytest.mark.gpu
def test_elu_construction_on_card_matches_cpu(cuda):
    from powersystemsreliabilityassessment_tpu_torch.engines import elu
    u, z, args, lfu = _elu_inputs(cuda, 64)
    got_y, got_h = elu.elu_mc_from_draws(u, z, *args, lfu)
    want_y, want_h = elu.elu_mc_from_draws(u.cpu(), z.cpu(), *args, lfu)
    assert float(want_y.sum()) > 0
    assert torch.equal(got_y.cpu(), want_y)
    assert float((got_h.cpu() - want_h).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_elu_loop_never_waits_for_the_device(cuda):
    from powersystemsreliabilityassessment_tpu_torch.engines import elu
    u, z, args, lfu = _elu_inputs(cuda, 32)
    dev = [torch.as_tensor(np.asarray(a), device=cuda) for a in args]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lole_y, hourly = elu.elu_mc_from_draws(u, z, *dev, lfu)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert lole_y.shape == (32,) and hourly.shape == (8760,)
    assert float(lole_y.mean()) > 0


# -- the multilevel-splitting SEQ study and the command line on the card ---

@pytest.mark.gpu
def test_split_k1_midyear_level_reduces_to_plain_on_card(cuda):
    # tests/test_torch_seq_split.py's check on the card: K = 1 at a level
    # entered mid-year rebuilds the never-split estimate on the same seed.
    from powersystemsreliabilityassessment_tpu_torch.studies.hl2_seq_split import (  # noqa: E501
        SplitConfig, run_seq_split_study)
    cfg = MCSConfig(max_years=16, cov_threshold=0.0, seed=2)
    kw = dict(device=cuda, years_per_device=8, max_lp=64, hours=504,
              log_every=0, load_scale=1.2)
    never = run_seq_split_study(
        cases.rts24(), cfg, SplitConfig(level_mw=-1e9, k_clones=3,
                                        max_split=2), **kw)
    before = ipm_fused.launches["fused_ipm_iterations"]
    k1 = run_seq_split_study(
        cases.rts24(), cfg, SplitConfig(level_mw=-100.0, k_clones=1,
                                        max_split=4), **kw)
    assert ipm_fused.launches["fused_ipm_iterations"] > before
    assert k1.split_entered > 0 and never.split_entered == 0
    assert k1.eens_mwh_yr == pytest.approx(never.eens_mwh_yr, rel=1e-6)
    assert k1.lole_hr_yr == never.lole_hr_yr
    assert k1.lolf_occ_yr == never.lolf_occ_yr


@pytest.mark.gpu
def test_split_step_never_waits_for_the_device(cuda):
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_seq_split)
    case = cases.rts24()
    sys_ = build_system(case, device=cuda)
    hours = 8736
    mt = twostate.mean_times(case)
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    step = hl2_seq_split.make_split_batch_step(
        sys_, 16, CompatFlags(), IPMConfig(), hours, k, 256,
        load_profile.load_factors(hours),
        hl2_seq_split.SplitConfig(level_mw=300.0))
    step(hl2_nsq.batch_generator(0, 0, cuda))      # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(hl2_nsq.batch_generator(0, 1, cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out).all()) and int(out[1]) == 0


@pytest.mark.gpu
def test_cli_nsq_on_card(cuda, tmp_path, capsys):
    from powersystemsreliabilityassessment_tpu_torch.__main__ import main
    before = ipm_fused.launches["fused_ipm_iterations"]
    main(["nsq", "--samples", "16384", "--batch", "8192", "--seed", "5",
          "--out", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"edns", "lole", "plc", "beta"}
    assert ipm_fused.launches["fused_ipm_iterations"] > before
    data = json.loads((tmp_path / "nsq_results.json").read_text())
    assert data["samples"] == 16384 and data["edns_mw"] == line["edns"]
    assert math.isfinite(line["edns"]) and line["edns"] > 0
