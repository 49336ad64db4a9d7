"""PyTorch port: the launch shape of the fused sampler + first-pass
certificate kernel (K4, ``ops/fused_sampler_cert.py::launch_shape``).

The kernel (``csrc/fused_sampler_cert.cu``) runs one thread per state
lane, or a few where the batch is small, and reads back its lanes a
block from the shared bytes the wrapper gives it, so the plan must
mirror the kernel's layout exactly: the broadcast vectors, PTDF with
rows padded to the flow chunk, LODF where it fits, then a fixed number
of bytes a lane. At RTS-24's dimensions and at synthetic ones at the 128
limit, for the batches the paths launch, the plan must fit a block's 227
KB, stage LODF only where it fits, take at most 128 lanes and 256
threads a block, and give an H100's 132 SMs a block each at the fused
study's 8,192 lanes.
"""
import re
from pathlib import Path

import pytest
import torch

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.ops import (
    certify_kernel as ck, fused_sampler_cert as ff)

from test_torch_gpu import k4_limit_case   # JAX-free, shared

torch.set_num_threads(1)

SMS = 132                  # an H100 SXM
SMEM = 227 * 1024          # shared memory a block may take
CSRC = Path(ff.__file__).resolve().parents[1] / "csrc"

# (ng, nd, nl, nb): RTS-24, the ring of tests/test_torch_gpu.py, and
# the widest systems `supported` takes (every dimension <= 128, n_comp =
# ng + nl <= 128).
DIMS = {"rts24": (33, 17, 38, 24), "ring120": (8, 120, 120, 120),
        "limit_branches": (1, 128, 127, 128),
        "limit_units": (127, 128, 1, 128), "even": (64, 128, 64, 128)}


def _r4(n):
    return (n + 3) // 4 * 4


def _layout(ng, nd, nl, nb):
    """(vectors, PTDF, LODF, per-lane) bytes of the kernel's layout, from
    its source's description (csrc/fused_sampler_cert.cu)."""
    nc = ng + nl
    vectors = 4 * _r4(nc + 3 * ng + 3 * nd + 3 * nb + nl + 2)
    ptdf = 4 * nb * ((nl + 7) // 8 * 8)
    return vectors, ptdf, 4 * _r4(nl * nl), 4 * nb + _r4(max(nc, 4 * nd))


@pytest.mark.parametrize("name", sorted(DIMS))
@pytest.mark.parametrize("batch", [1, 8192, 262144])
def test_launch_shape_fits_and_stages_only_what_fits(name, batch):
    dims = DIMS[name]
    lanes, stage, smem = ff.launch_shape(*dims, batch, SMS)
    vectors, ptdf, lodf, lane = _layout(*dims)
    split = 1 << (stage >> ff.SPLIT_SHIFT)
    assert smem <= SMEM == ff.SMEM_PER_BLOCK
    assert lanes % 32 == 0 and 32 <= lanes <= ff.MAX_LANES == 128
    assert lanes * split <= ff.MAX_THREADS == 256
    assert stage & ck.STAGE_PTDF and not stage & ck.STAGE_TRANSFER
    base = vectors + ptdf + lanes * lane
    staged = bool(stage & ck.STAGE_LODF)
    assert staged == (base + lodf <= SMEM)
    assert smem == base + (lodf if staged else 0)
    # The kernel's inverse: lanes = (smem - staged words) / lane bytes.
    assert (smem - (vectors + ptdf + (lodf if staged else 0))) == \
        lanes * lane
    if batch == 1:
        assert lanes == 32 and split == 8
    if batch == 8192:       # the fused study: a block for every SM, and
        # four threads a lane (32,768 threads, ~2 warps a scheduler)
        assert -(-batch // lanes) >= SMS and split == 4
    if batch == 262144:     # the fused bench step: 2,048 blocks of 128
        assert lanes == 128 and split == 1


def test_rts24_stages_everything():
    for batch in (1, 8192, 262144):
        _, stage, smem = ff.launch_shape(*DIMS["rts24"], batch, SMS)
        assert stage & 7 == ck.STAGE_PTDF | ck.STAGE_LODF
        assert smem <= 40 * 1024


@pytest.mark.parametrize("batch", [1, 5000, 8192, 16384, 33000, 262144])
def test_split_fills_the_card_and_stops_at_eight(batch):
    lanes, stage, _ = ff.launch_shape(*DIMS["rts24"], batch, SMS)
    split = 1 << (stage >> ff.SPLIT_SHIFT)
    threads = batch * split
    assert split == 8 or threads >= ff.THREADS_PER_SM * SMS // 2
    assert split == 1 or threads <= ff.THREADS_PER_SM * SMS


def test_overrides_are_checked():
    dims = DIMS["rts24"]
    assert ff.launch_shape(*dims, 8192, SMS, lanes=64, split=4)[0] == 64
    for lanes, split in ((48, 1), (160, 1), (64, 8), (32, 3)):
        with pytest.raises(ValueError):
            ff.launch_shape(*dims, 8192, SMS, lanes=lanes, split=split)


def test_limit_leaves_lodf_to_the_cache_at_128_lanes():
    for name in ("ring120", "limit_branches"):
        lanes, stage, _ = ff.launch_shape(*DIMS[name], 262144, SMS)
        assert lanes == 128 and not stage & ck.STAGE_LODF
        lanes, stage, _ = ff.launch_shape(*DIMS[name], 8192, SMS)
        assert lanes == 32 and stage & ck.STAGE_LODF


def test_plan_matches_the_systems_it_runs():
    sys_ = build_system(cases.rts24(), device="cpu")
    assert (sys_.n_gen, sys_.n_load, sys_.n_branch, sys_.n_bus) == \
        DIMS["rts24"]
    ring = build_system(k4_limit_case(), device="cpu")
    assert (ring.n_gen, ring.n_load, ring.n_branch, ring.n_bus) == \
        DIMS["ring120"]
    assert ff.supported(ring) and ring.n_comp == 128


def test_plan_constants_match_the_kernel_source():
    src = (CSRC / "fused_sampler_cert.cu").read_text()
    const = lambda name, text=src: int(re.search(
        rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("QUICK_MAX_LANES") == ff.MAX_LANES
    assert const("QUICK_MAX_THREADS") == ff.MAX_THREADS
    # The flow chunk lives in the header K4 shares with K5.
    assert const("FLOW_CHUNK", (CSRC / "lane_common.cuh").read_text()) \
        == ff.CHUNK
    assert const("QUICK_SPLIT_SHIFT") == ff.SPLIT_SHIFT
