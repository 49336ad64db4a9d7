"""The m <= 72 LP tier's CUDA graphs (``runtime/graphs.py``,
``engines/lp_ipm_structured.lp_chain``).

On the CPU: a solve on CPU tensors takes no chain (the rule itself,
``graphs.chain_for``, is tested through both of its layers in
tests/test_torch_graph_rule.py). On the card: the graph
path against the eager path, bit for bit, over three consecutive LP
buffers (an RTS-24 SEQ step's 1,024-lane buffer and a 2,048-lane NSQ
buffer), K1's four eager launches a solve and the inputs they were
handed, and the LP tier's counters.

Tests that need a card carry the ``gpu`` marker and skip without one:

    python -m pytest --noconftest -m gpu tests/test_torch_lp_graphs.py
"""
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu_torch.core import (
    cases, load_profile)
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    dcopf, lp_ipm_batched, lp_ipm_structured as ls)
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.runtime import graphs
from powersystemsreliabilityassessment_tpu_torch.sampling import chronological
from powersystemsreliabilityassessment_tpu_torch.studies import (
    hl2_nsq, hl2_seq)
from powersystemsreliabilityassessment_tpu_torch.utils import profiling

torch.set_num_threads(1)

FIELDS = ("dns_mw", "nodal_mw", "gen_dispatch", "primal_residual",
          "failure", "infeasible")


@pytest.fixture
def chains(monkeypatch):
    """A fresh chain cache."""
    cache = graphs.ChainCache(ls.GRAPH_CHAINS)
    monkeypatch.setattr(ls, "_chains", cache)
    return cache


def test_cpu_solve_takes_no_chain(chains):
    # The CPU path runs the segments as plain calls and caches nothing.
    sys_ = build_system(cases.rts24(), device="cpu")
    rng = np.random.default_rng(3)
    down = torch.as_tensor(rng.uniform(size=(32, 71)) < 0.1)
    load = sys_.load_pd[None].expand(32, -1)
    res = dcopf.evaluate_states(sys_, down, load)
    assert res.dns_mw.shape == (32,) and len(chains) == 0


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _seq_buffers(sys_, n=3, lanes=1024, years=4, seed=2026):
    """The LP buffers of ``n`` consecutive RTS-24 SEQ steps of ``years``
    years, as the screened evaluator fills them: the hour-states tier 1
    leaves for the LP first, the rest in lane order; (states, loads,
    real-lane mask) each."""
    hours = 8736
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    load = hl2_seq.year_block_load(sys_, load_profile.load_factors(hours),
                                   years)
    out = []
    for i in range(n):
        flat = hl2_seq.sample_years(
            hl2_nsq.batch_generator(seed, i, sys_.device), sys_, years,
            hours, k).transpose(1, 2).reshape(years * hours, -1)
        cert = dcopf.certify_states(sys_, flat, load,
                                    repair_buffer=years * hours // 16)
        need = (~cert.certified) | (cert.deficit > 0)
        idx = dcopf._topk_lanes(need, lanes)
        valid = (torch.arange(lanes, device=idx.device) < need.sum()) \
            & need[idx]
        out.append((flat[idx], load[idx], valid))
    return out


def _nsq_buffers(sys_, n=3, lanes=2048, seed=7):
    """``n`` 2,048-lane NSQ buffers: states at three times the outage
    rates (the synchronous condenser up), peak load, three branches out
    on every 32nd lane."""
    case = cases.rts24()
    u = twostate.unavailability(case)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        down = rng.uniform(size=(lanes, case.n_comp)) < 3 * u[None, :]
        down[:, 14] = False
        for lane in range(0, lanes, 32):
            down[lane, case.n_gen + rng.choice(case.n_branch, 3,
                                               replace=False)] = True
        d = torch.as_tensor(down, device=sys_.device)
        out.append((d, sys_.load_pd[None].expand(lanes, -1),
                    torch.ones(lanes, dtype=torch.bool, device=d.device)))
    return out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _evaluate(sys_, buffers):
    return [dcopf.evaluate_states(sys_, d, l, valid=v)
            for d, l, v in buffers]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["seq1024", "nsq2048"])
def test_graph_path_is_bit_equal_to_eager(cuda, kind, monkeypatch):
    # Three consecutive buffers through the graphs, all kept, then the
    # same through the eager calls: a stale static input or an output a
    # later replay overwrote would differ.
    monkeypatch.setattr(ls, "_chains", graphs.ChainCache(ls.GRAPH_CHAINS))
    sys_ = build_system(cases.rts24(), device=cuda)
    buffers = (_seq_buffers if kind == "seq1024" else _nsq_buffers)(sys_)
    lanes = buffers[0][0].shape[0]
    assert lanes <= ls.GRAPH_MAX_LANES
    graphed = _evaluate(sys_, buffers)
    assert len(ls._chains) == 2
    segs = sorted(s for c in ls._chains._chains.values() for s in c.segments)
    assert segs == ["finalize", "polish", "rescue"]
    monkeypatch.setattr(ls, "GRAPH_MAX_LANES", 0)
    eager = _evaluate(sys_, buffers)
    torch.cuda.synchronize()
    for g, e in zip(graphed, eager):
        for f in FIELDS:
            assert torch.equal(_bits(getattr(g, f)), _bits(getattr(e, f))), f
    assert any(bool(e.dns_mw.gt(0).any()) for e in eager)


@pytest.mark.gpu
def test_graph_path_keeps_k1_eager_and_the_counters(cuda, monkeypatch):
    # A recorder like the benchmark's K1 recorder sees the same four
    # launches a solve on both paths; the inputs it kept from the first
    # solve still hold their values after the second; the LP tier's
    # counters read the same on both paths.
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(ls, "_chains", graphs.ChainCache(ls.GRAPH_CHAINS))
    sys_ = build_system(cases.rts24(), device=cuda)
    buffers = _nsq_buffers(sys_, n=2)
    kernels = lp_ipm_batched._DIRECT_KERNELS["cuda"]
    calls = []

    def iterate(st, colscale, br_up, c, b, l, u, cfg, x_init=None):
        args = (colscale, br_up, c, b, l, u) + (
            () if x_init is None else (x_init,))
        calls.append((args, tuple(a.clone() for a in args)))
        return kernels.iterate(st, colscale, br_up, c, b, l, u, cfg,
                               x_init=x_init)

    monkeypatch.setitem(lp_ipm_batched._DIRECT_KERNELS, "cuda",
                        kernels._replace(iterate=iterate))

    def run(graph_lanes):
        monkeypatch.setattr(ls, "GRAPH_MAX_LANES", graph_lanes)
        _evaluate(sys_, buffers[:1])              # captures on the card
        calls.clear()
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            first = _evaluate(sys_, buffers[:1])[0]
            n_first = len(calls)
            second = _evaluate(sys_, buffers[1:])[0]
        torch.cuda.synchronize()
        got = profiling.counters()
        profiling.reset_counters()
        assert n_first == 4 and len(calls) == 8
        for kept, values in calls[:4]:
            for a, v in zip(kept, values):
                assert torch.equal(a, v)
        return first, second, got

    g_first, g_second, g_got = run(ls.GRAPH_MAX_LANES)
    e_first, e_second, e_got = run(0)
    assert g_got["lp.graph_replays"] == 6
    assert "lp.graph_replays" not in e_got
    for name in ("lp.rescue_demand", "lp.guard_fallback"):
        assert g_got[name] == e_got[name], name
    assert g_got["lp.rescue_demand"] > 0
    for g, e in ((g_first, e_first), (g_second, e_second)):
        assert torch.equal(_bits(g.dns_mw), _bits(e.dns_mw))


@pytest.mark.gpu
def test_capture_under_a_profiler(cuda, monkeypatch):
    # A study profiled from its start captures inside the profiler: the
    # graphs still give the eager bits, and the counters see three
    # captures and three replays.
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(ls, "_chains", graphs.ChainCache(ls.GRAPH_CHAINS))
    sys_ = build_system(cases.rts24(), device=cuda)
    buffers = _seq_buffers(sys_, n=1)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        graphed = _evaluate(sys_, buffers)
        torch.cuda.synchronize()
    got = profiling.counters()
    profiling.reset_counters()
    assert got["lp.graph_captures"] == 3 and got["lp.graph_replays"] == 3
    monkeypatch.setattr(ls, "GRAPH_MAX_LANES", 0)
    eager = _evaluate(sys_, buffers)
    for f in FIELDS:
        assert torch.equal(_bits(getattr(graphed[0], f)),
                           _bits(getattr(eager[0], f))), f
