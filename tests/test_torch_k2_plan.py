"""PyTorch port: K2's launch plan and inputs, on the CPU.

K2a (``csrc/batched_chol.cu``) reads its launch shape and shared layout
from ``ops/batched_chol.py::launch_shape`` / ``lane_words`` /
``row_offset``; these tests hold them to what the kernel assumes (the
227 KB opt-in, 16-byte aligned rows with room for a 4-column piece, a
quarter warp's column reads on distinct bank groups) and replay the
kernel's staging and storing walks. The kernel reads only M's lower
triangle (a_jk for the reference's a_kj), so on the path's own matrices
(the RTS-24 polish's equilibrated normal matrices, RTS-96's diagonal
panels) the plain factor of M and of its lower triangle mirrored are
held together, and the JAX reference (Pallas kernels in interpret mode)
against both. The kernels against their plain versions on the card are
in tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.ops import batched_chol as ref_bc

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.ops import (
    batched_chol as bc, blocked_chol as bl)
from test_torch_gpu import (   # JAX-free, shared
    _polish_matrices, _stressed_states, rts96_normal_matrices)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

K2_L_BOUND = 1e-4    # chip_smoke.py: per-lane |L - L_plain| / max(1, |L|)
K2_X_BOUND = 1e-3    # chip_smoke.py: per-lane |x - x_plain| / max(1, |x|)
H100_SMS = 132
PATH_BATCHES = (1, 3, 255, 256, 257, 2048, 2049)


def _lane_rel_err(a, b):
    lane = lambda t: t.abs().flatten(1).amax(1)
    return lane(a - b) / lane(b).clamp_min(1.0)


@pytest.mark.parametrize("batch", PATH_BATCHES)
def test_launch_shape_fits_the_opt_in_for_every_m(batch):
    for m in range(1, bc.MAX_M + 1):
        for wpl in (None, *bc.WARPS_PER_LANE):
            w, lpb, smem = bc.launch_shape(batch, m, H100_SMS, wpl)
            assert w in bc.WARPS_PER_LANE and (wpl is None or w == wpl)
            assert 1 <= lpb and lpb * w <= bc.MAX_WARPS_PER_BLOCK
            assert smem == 4 * lpb * bc.lane_words(m, w)
            assert smem <= bc.SMEM_PER_BLOCK
            assert bc.lane_words(m, w) % 4 == 0   # lanes stay 16-byte aligned


def test_launch_shape_at_the_path_shapes():
    # Measured on the card (PERF.md §6): four warps a lane at the
    # RTS-24 polish's 256 lanes, one at RTS-96's 2,048.
    assert bc.launch_shape(256, 62, H100_SMS)[:2] == (4, 1)
    assert bc.launch_shape(2048, 56, H100_SMS)[:2] == (1, 8)
    assert bc.launch_shape(2048, 23, H100_SMS)[:2] == (1, 8)
    with pytest.raises(ValueError, match="m <= 72"):
        bc.launch_shape(256, 73, H100_SMS)
    with pytest.raises(ValueError, match="warps a lane"):
        bc.launch_shape(256, 62, H100_SMS, 3)


@pytest.mark.parametrize("m", [1, 2, 7, 8, 9, 23, 56, 62, 64, 72])
def test_row_layout_is_aligned_disjoint_and_conflict_free(m):
    offs = [bc.row_offset(i) for i in range(m)]
    tri_words = bc.lane_words(m, 1) - 4 * m
    for i, o in enumerate(offs):
        assert o % 4 == 0                               # 16-byte aligned
        # Entries, and a 4-column piece from any multiple of 4 <= i, and
        # the clamped panel read at 8 (i // 8) + 8.
        assert bc.row_words(i) >= max(i + 1, 4 * (i // 4) + 4,
                                      8 * (i // 8) + 12)
        assert o + bc.row_words(i) <= tri_words
        if i + 1 < m:
            assert o + bc.row_words(i) <= offs[i + 1]    # disjoint, ordered
    for g in range(0, m, 8):
        units = [(o // 4) % 8 for o in offs[g:g + 8]]
        assert len(set(units)) == len(units)   # distinct 16-byte bank groups


def _stage_walk(m, V, tid, nt):
    """The pieces thread ``tid`` of ``nt`` copies in the kernel's
    ``stage_lower<V>``: (row, first column)."""
    out, i, c = [], 0, tid
    while c > i // V:
        c -= i // V + 1
        i += 1
    while i < m:
        out.append((i, V * c))
        c += nt
        while c > i // V:
            c -= i // V + 1
            i += 1
    return out


@pytest.mark.parametrize("m", [1, 2, 4, 23, 56, 62, 64, 72])
def test_staging_walk_covers_the_lower_triangle_once(m):
    for V in (v for v in (1, 2, 4) if m % v == 0):
        for nt in (32, 64, 128):
            seen = []
            for tid in range(nt):
                for i, j in _stage_walk(m, V, tid, nt):
                    assert j <= i and j + V <= m           # inside the row
                    assert j + V <= bc.row_words(i)        # and its room
                    seen += [(i, j + q) for q in range(V) if j + q <= i]
            assert sorted(seen) == [(i, j) for i in range(m)
                                    for j in range(i + 1)]


@pytest.mark.parametrize("m", [1, 2, 23, 56, 62, 72])
def test_store_walk_covers_the_square_once(m):
    # store_lower<V>: flat piece p of the square, row i = p // (m / V),
    # loads clamped to the row's diagonal piece.
    for V in (v for v in (1, 2, 4) if m % v == 0):
        n = m // V
        for nt in (32, 128):
            seen = []
            for tid in range(nt):
                i, c = 0, tid
                while c >= n:
                    c -= n
                    i += 1
                for p in range(tid, m * n, nt):
                    assert p == i * n + c
                    assert min(V * c, V * (i // V)) + V <= bc.row_words(i)
                    seen.append(p)
                    c += nt
                    while c >= n:
                        c -= n
                        i += 1
            assert sorted(seen) == list(range(m * n))


@pytest.fixture(scope="module")
def path_matrices():
    """The path's K2a inputs built on the CPU, 128 lanes each: the
    RTS-24 polish's equilibrated A A' (m = 62) and the first and last
    diagonal panels (56 and 23 wide) of one blocked factorization of
    RTS-96 normal matrices."""
    sys_ = build_system(cases.rts24(), device="cpu")
    polish = _polish_matrices(sys_, _stressed_states(128, 41))
    M191, panels = rts96_normal_matrices("cpu", n=128), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bc, "cholesky",
                   lambda S: panels.append(S.clone()) or bc.cholesky_plain(S))
        bl._factor_once(M191)
    assert [p.shape[-1] for p in panels] == [56, 56, 56, 23]
    return {"polish": polish, "p56": panels[0], "p23": panels[-1]}


def _mirrored_lower(M):
    low = torch.tril(M)
    return low + torch.tril(M, -1).transpose(1, 2)


@pytest.mark.parametrize("name", ["polish", "p56", "p23"])
def test_reading_the_lower_triangle_changes_rounding_only(path_matrices,
                                                          name):
    M = path_matrices[name]
    asym = float(((M - M.transpose(1, 2)).abs().flatten(1).amax(1)
                  / M.abs().flatten(1).amax(1)).max())
    assert asym < 1e-6    # symmetric to rounding, not exactly
    L_full = bc.cholesky_plain(M)
    L_low = bc.cholesky_plain(_mirrored_lower(M))
    assert bool(torch.isfinite(L_low).all())
    assert float(_lane_rel_err(L_low, L_full).max()) <= K2_L_BOUND


@pytest.mark.parametrize("name", ["polish", "p56", "p23"])
def test_reference_agrees_with_both_readings(path_matrices, name):
    M = path_matrices[name]
    L_ref = torch.as_tensor(np.array(ref_bc.from_batch_minor(
        ref_bc.cholesky_bm(ref_bc.to_batch_minor(jnp.asarray(M.numpy()))))))
    for A in (M, _mirrored_lower(M)):
        assert float(_lane_rel_err(bc.cholesky_plain(A), L_ref).max()) \
            <= K2_L_BOUND
    if name == "polish":
        r = torch.as_tensor(np.random.default_rng(8).normal(
            size=M.shape[:2]), dtype=torch.float32)
        bm = lambda t: ref_bc.to_batch_minor(jnp.asarray(t.numpy()))
        x_ref = torch.as_tensor(np.array(ref_bc.from_batch_minor(
            ref_bc.cho_solve_bm(bm(L_ref), bm(r)))))
        x = bc.cho_solve_plain(L_ref, r)
        assert float(_lane_rel_err(x, x_ref).max()) <= K2_X_BOUND
