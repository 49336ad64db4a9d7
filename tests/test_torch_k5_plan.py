"""PyTorch port: the launch shape and shared layouts of the whole-
certificate kernel (K5, ``ops/certify_kernel.py::launch_shape``).

The first pass (``csrc/certify_kernel.cu``) runs one thread per state
lane, or a few where the batch is small, and refuses any shared size
but the one its stage bits imply, so the plan must mirror its layout
exactly: the network's small vectors, PTDF with rows padded to the flow
chunk, LODF and the transfer matrix where they fit a staging budget of
half the block's 227 KB, then a fixed number of words a lane (bus injections, the
load row at an odd stride, the exchange region of the state bytes and
the dispatch at an odd stride). The repair kernel stages the same
matrices beside 32 slots. At RTS-24's and RTS-96's dimensions, at the
120-bus ring's (an even number of loads) and at synthetic ones at the 128 limit, for the
batches the paths launch: both layouts fit a block's 227 KB, the
strides spread a warp over the 32 banks, the repair's list holds every
lane and its rounds take each listed lane once.
"""
import re
from pathlib import Path

import pytest
import torch

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.ops import (
    certify_kernel as ck)

from test_torch_gpu import k4_limit_case   # JAX-free, shared

torch.set_num_threads(1)

SMS = 132                  # an H100 SXM
SMEM = 227 * 1024          # shared memory a block may take
CSRC = Path(ck.__file__).resolve().parents[1] / "csrc"

# (ng, nd, nl, nb): RTS-24, RTS-96, the ring of tests/test_torch_gpu.py
# and systems with every dimension at the limit of 128.
DIMS = {"rts24": (33, 17, 38, 24), "rts96": (99, 51, 119, 72),
        "ring120": (8, 120, 120, 120), "limit": (128, 128, 128, 128),
        "even": (64, 128, 64, 128)}


def _r4(n):
    return (n + 3) // 4 * 4


def _layout(ng, nd, nl, nb):
    """(staged words without LODF / transfer, one square matrix, words a
    lane, words a repair slot) from the kernel source's description."""
    small = _r4(6 * ng + 2 * nd + 2 * nl + 2 * nb + 2)
    ptdf = nb * ((nl + 7) // 8 * 8)
    lane = nb + (nd | 1) + max((ng + nl + 3) // 4, ng | 1)
    slot = ng + 2 * nd + 2 * nl + nb + 16
    return small + ptdf, _r4(nl * nl), lane, slot


@pytest.mark.parametrize("name", sorted(DIMS))
@pytest.mark.parametrize("batch", [1, 8192, 262144])
def test_launch_shape_fits_and_stages_only_what_fits(name, batch):
    dims = DIMS[name]
    lanes, stage, smem = ck.launch_shape(*dims, batch, SMS)
    base, square, lane, slot = _layout(*dims)
    split = 1 << (stage >> ck.SPLIT_SHIFT & 3)
    assert lanes == ((stage >> ck.LANES_SHIFT & 3) + 1) * 32
    assert lanes % 32 == 0 and 32 <= lanes <= ck.MAX_LANES == 128
    assert lanes * split <= ck.MAX_THREADS == 256
    assert stage & ck.STAGE_PTDF
    n_sq = sum(bool(stage & b) for b in (ck.STAGE_LODF, ck.STAGE_TRANSFER))
    # The kernel's cert_smem_bytes: staged words, then the tile's lanes.
    assert smem == 4 * (base + n_sq * square + lanes * lane) <= SMEM
    # LODF before the transfer matrix, each only within the budget, and
    # only where the repair kernel fits beside it.
    assert not (stage & ck.STAGE_TRANSFER) or stage & ck.STAGE_LODF
    assert smem <= ck.STAGE_BUDGET or n_sq == 0
    bare, rep_bare = 4 * (base + lanes * lane), 4 * (base + 32 * (slot + 31))
    if not stage & ck.STAGE_LODF:
        assert bare + 4 * square > ck.STAGE_BUDGET \
            or rep_bare + 4 * square > SMEM
    # The repair kernel: the same matrices beside 32 slots padded by up
    # to 31 words each.
    rep = ck.repair_smem(*dims, stage)
    assert rep == 4 * (base + n_sq * square + 32 * (slot + 31)) <= SMEM


def test_rts24_and_rts96_shapes():
    # RTS-24 at the bench batch: 128 lanes a block, every matrix staged.
    lanes, st24, _ = ck.launch_shape(*DIMS["rts24"], 262144, SMS)
    assert lanes == 128 and st24 & 7 == 7
    lanes, st96, smem = ck.launch_shape(*DIMS["rts96"], 8192, SMS)
    # RTS-96 at the study's batch: 32 lanes of four threads, 256 blocks
    # on 132 SMs; LODF and the transfer matrix (57 KB each) through L2.
    assert (lanes, 1 << (st96 >> ck.SPLIT_SHIFT & 3)) == (32, 4)
    assert st96 & 7 == ck.STAGE_PTDF and smem <= ck.STAGE_BUDGET


def test_the_limit_takes_fewer_lanes_to_fit():
    lanes, _, smem = ck.launch_shape(*DIMS["limit"], 262144, SMS)
    assert lanes < 128 and smem <= SMEM
    assert ck.launch_shape(*DIMS["rts24"], 262144, SMS)[0] == 128


@pytest.mark.parametrize("name", sorted(DIMS))
def test_row_strides_spread_a_warp_over_the_banks(name):
    # Lane t reads its own row at one index: t * stride + j. An odd
    # stride puts a warp's 32 lanes in 32 banks; the 120-bus ring's 120
    # loads and the even synthetic system take a padded stride.
    ng, nd, nl, nb = DIMS[name]
    w = ck.layout_words(ng, nd, nl, nb, 32)
    for stride, width in ((w["load_stride"], nd), (w["disp_stride"], ng)):
        assert stride in (width, width + 1) and stride % 2 == 1
        assert len({(t * stride) % 32 for t in range(32)}) == 32
    assert DIMS["ring120"][1] % 2 == 0


@pytest.mark.parametrize("split", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("name", ["rts24", "rts96", "limit"])
def test_repair_slots_spread_a_round_over_the_banks(name, split):
    # Slot s's words start at s * w, w the slot's words rounded up to
    # split modulo 32 (repair_kernel); thread r of slot s reads element
    # r + m split: the 32 threads of a warp hit 32 banks.
    words = _layout(*DIMS[name])[3]
    w = words + ((split - words) % 32)
    assert w - words <= 31 and w % 32 == split % 32
    for m in range(3):
        banks = {(s * w + r + m * split) % 32
                 for s in range(32 // split) for r in range(split)}
        assert len(banks) == 32


def _repair_rounds(n_q, grid, threads=128):
    """The repair kernel's schedule: (block, first row, lanes, threads a
    lane) of every round."""
    per = max(1, min(32, -(-n_q // grid)))
    out = []
    for block in range(grid):
        base = block * per
        while base < n_q:
            n = min(n_q - base, per)
            split = threads // 32
            while 2 * split <= 32 and 2 * split * n <= threads:
                split *= 2
            out.append((block, base, n, split))
            base += grid * per
    return out


@pytest.mark.parametrize("n_q", [0, 1, 31, 33, 1580, 18381, 262144])
def test_repair_rounds_take_every_listed_lane_once(n_q):
    # The list (its count and a row for every lane of the batch) is sized
    # for the worst case, every lane listed; the rounds read the count on
    # the device and take each listed row once, at most 32 a round, with
    # a power of two of threads a lane that fits the block.
    grid = 660
    rounds = _repair_rounds(n_q, grid)
    rows = sorted(r for _, base, n, _ in rounds for r in range(base, base + n))
    assert rows == list(range(n_q))
    for _, _, n, split in rounds:
        assert 1 <= n <= ck.REPAIR_SLOTS and split & (split - 1) == 0
        assert 4 <= split <= 32 and n * split <= 128
    if 0 < n_q <= grid:                        # a short list: a warp a lane
        assert all(split == 32 for *_, split in rounds)


def test_plan_matches_the_systems_it_runs():
    for name in ("rts24", "rts96"):
        s = build_system(getattr(cases, name)(), device="cpu")
        assert (s.n_gen, s.n_load, s.n_branch, s.n_bus) == DIMS[name]
        ck.check_dims(s, "k5")
    ring = build_system(k4_limit_case(), device="cpu")
    assert (ring.n_gen, ring.n_load, ring.n_branch, ring.n_bus) == \
        DIMS["ring120"]
    fbuf, ibuf = ck.kernel_operands(ring)
    # The network buffers and the extra float (the units' total
    # capacity) the kernel reads after them.
    ng, nd, nl, nb = DIMS["ring120"]
    assert fbuf.numel() == nb * nl + 2 * nl * nl + ng + 2 * nl + 1
    assert float(fbuf[-1]) == pytest.approx(float(ring.gen_pmax.sum()))
    assert ibuf.numel() == ng + nd + 2 * (nb + 1) + ng + nd


def test_overrides_are_checked():
    dims = DIMS["rts24"]
    assert ck.launch_shape(*dims, 8192, SMS, lanes=64, split=2)[0] == 64
    for lanes, split in ((48, 1), (160, 1), (64, 8), (32, 3)):
        with pytest.raises(ValueError):
            ck.launch_shape(*dims, 8192, SMS, lanes=lanes, split=split)


def test_plan_constants_match_the_kernel_source():
    src = (CSRC / "certify_kernel.cu").read_text()
    lane = (CSRC / "lane_common.cuh").read_text()
    const = lambda name, text=src: int(re.search(
        rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("CERT_MAX_LANES") == ck.MAX_LANES
    assert const("CERT_MAX_THREADS") == ck.MAX_THREADS
    assert const("REPAIR_SLOTS") == ck.REPAIR_SLOTS
    assert const("REPAIR_THREADS") == 128
    assert const("CERT_SPLIT_SHIFT") == ck.SPLIT_SHIFT
    assert const("CERT_LANES_SHIFT") == ck.LANES_SHIFT
    assert const("FLOW_CHUNK", lane) == ck.CHUNK
    assert const("SUM_PARTS", lane) == 8
