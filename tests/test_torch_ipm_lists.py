"""PyTorch port: the incidence lists K1 forms its products from, and its
launch shape (``ops/ipm_fused.py``).

The CUDA kernel (``csrc/ipm_fused.cu``) never reads the dense balance
block A0 = [Cg | Cd | -Minc' | 0] or the gauge-fixed incidence Mref: it
takes each generator's and load's bus, each branch's ends and A0's
nonzero columns of each bus row. Those lists must rebuild both blocks
exactly, on the systems the port runs and on the edge cases of
tests/test_torch_gpu.py. The launch shape must fit a block's shared
memory at the K1 route's largest row count and refuse a larger one.
"""
import pytest
import torch

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused

from test_torch_gpu import edge_case   # JAX-free, shared

torch.set_num_threads(1)


def _structure(name):
    case = getattr(cases, name)() if hasattr(cases, name) else edge_case(name)
    return ipm_fused.build_structure(build_system(case, device="cpu"))


def _dense_from_lists(st):
    """A0 and Mref rebuilt from the incidence lists alone."""
    nb, ng, nd, nl = st.nb, st.ng, st.nd, st.nl
    a0 = torch.zeros((nb, st.n))
    a0[st.gen_bus.long(), torch.arange(ng)] = 1.0
    a0[st.load_bus.long(), ng + torch.arange(nd)] = 1.0
    f = ng + nd + torch.arange(nl)
    a0[st.br_from.long(), f] = -1.0
    a0[st.br_to.long(), f] = 1.0
    mref = torch.zeros((nl, nb))
    mref[torch.arange(nl), st.br_from.long()] = 1.0
    mref[torch.arange(nl), st.br_to.long()] = -1.0
    mref[:, 0] = 0.0                                # reference bus
    return a0, mref


@pytest.mark.parametrize("name", ["rts24", "rts96", "m72", "m14"])
def test_index_lists_rebuild_the_dense_blocks(name):
    st = _structure(name)
    a0, mref = _dense_from_lists(st)
    assert torch.equal(a0, st.a0_bal)
    assert torch.equal(mref, st.minc_ref)
    # The CSR rows: each bus's nonzero columns of A0, ascending.
    for t in (st.gen_bus, st.load_bus, st.br_from, st.br_to, st.bus_ptr,
              st.bus_col):
        assert t.dtype == torch.int32 and t.is_contiguous()
    ptr, col = st.bus_ptr.long(), st.bus_col.long()
    assert int(ptr[0]) == 0 and int(ptr[-1]) == col.numel() == \
        st.ng + st.nd + 2 * st.nl
    for i in range(st.nb):
        cols = col[ptr[i]:ptr[i + 1]]
        assert torch.equal(cols, torch.nonzero(st.a0_bal[i]).flatten())


@pytest.mark.parametrize("name,m", [("rts24", 62), ("m72", 72)])
@pytest.mark.parametrize("batch", [1, 256, 2048, 100000])
def test_launch_shape_fits_shared_memory(name, m, batch):
    st = _structure(name)
    assert st.m == m
    lpb, wpl, smem = ipm_fused.launch_shape(st, batch, 132)
    assert 1 <= lpb <= ipm_fused.MAX_LANES_PER_BLOCK
    assert smem <= ipm_fused.SMEM_PER_BLOCK == 227 * 1024
    # 256 lanes: one a block, so every SM of an H100 holds one or two;
    # 2,048: four a block, 512 blocks. Two warps a lane up to 264 lanes
    # (one warp a scheduler of the 132 SMs), where the instance takes m.
    if batch <= 263:
        assert lpb == 1
    if batch >= 4 * 132:
        assert lpb == ipm_fused.MAX_LANES_PER_BLOCK
    assert wpl == (2 if batch <= 264 and m <= 64 else 1)
    per_lane = 4 * (m * (m + 1) // 2 + 6 * st.n + 2 * m + 2 * st.nl + 6)
    assert smem - lpb * per_lane == 4 * (2 * st.ng + 2 * st.nd + 5 * st.nl
                                         + st.nb + 1)


def test_launch_shape_refuses_m_above_72():
    st = _structure("rts96")
    assert st.m == 191
    with pytest.raises(ValueError, match="m <= 72"):
        ipm_fused.launch_shape(st, 256, 132)
