"""The screened evaluator's tier-1 pass as one CUDA graph a call
(``engines/dcopf.tier1_chain``, ``runtime/graphs.py``).

On the CPU (the rule that picks a graph chain or the eager call,
``graphs.chain_for``, is tested through both of its layers in
tests/test_torch_graph_rule.py): the bits of ``certify_states`` on the eager path (``DIGESTS``, recorded from the
code before the chain was added, with one intra-op thread: ``python -m
tests.test_torch_tier1_graphs`` prints them anew), that only the
screened evaluator's own pass takes a chain (not ``calibrate_shed_hint``
nor ``_finalize``), and the screened evaluator under a stand-in chain
that keeps the graph's contract (static inputs, outputs overwritten by
the next call). On the card: the graph path against the eager path, bit
for bit, over three consecutive RTS-24 SEQ year blocks (34,944 lanes)
and an 8,192-lane NSQ batch with the shed hint; a call's results after
the next call's replay; the replay and capture counters; a capture
under a running profiler.

Tests that need a card carry the ``gpu`` marker and skip without one:

    python -m pytest --noconftest -m gpu tests/test_torch_tier1_graphs.py
"""
import hashlib

import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu_torch.core import (
    cases, load_profile)
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.runtime import graphs
from powersystemsreliabilityassessment_tpu_torch.sampling import (
    chronological)
from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
    sample_states)
from powersystemsreliabilityassessment_tpu_torch.studies import (
    hl2_nsq, hl2_seq)
from powersystemsreliabilityassessment_tpu_torch.utils import profiling

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

FIELDS = ("dns_mw", "nodal_mw", "gen_dispatch", "primal_residual",
          "failure", "infeasible")

# certify_states on 1,024 stressed RTS-24 states (full-batch repair; a
# hint and a 256-lane repair buffer; rank-3 Woodbury and a 512-lane
# buffer), and the screened evaluator with the hint (a 32-lane LP buffer).
DIGESTS = {
    "hinted": "1b0fbf3922f9cd02aa960a338e9c7d859556cb069272d89b415849abdc492020",
    "plain": "61537e1ccb724116990d5fad8d4529a8918f2ae9805e5501abbf4af2a11b8c70",
    "rank3": "cb17406dfd94b3c3da176427ca5b867c33e39ff72c3517db6ad067f41e773d2c",
    "screened": "f60f091362cf4211be2b0ec97a3cae7926fcfdd34053f5cb4b29ea9274eb9475",
}
CERTIFY_CASES = {"plain": (False, None, 2), "hinted": (True, 256, 2),
                 "rank3": (False, 512, 3)}


@pytest.fixture(scope="module")
def rts24_cpu():
    return build_system(cases.rts24(), device="cpu")


def _stressed(sys_, n=1024, seed=5):
    """``n`` RTS-24 states at three times the outage rates (pinned units
    up), a branch out on every third lane and two on every 17th, at peak
    load; and a fixed shed hint ([n_load], sums to 1)."""
    case = cases.rts24()
    rng = np.random.default_rng(seed)
    down = rng.uniform(size=(n, sys_.n_comp)) < 3 * twostate.unavailability(
        case)[None, :]
    down[:, sys_.always_up_nsq.numpy()] = False
    ng, nl = sys_.n_gen, sys_.n_branch
    for lane in range(0, n, 3):
        down[lane, ng + rng.integers(nl)] = True
    for lane in range(0, n, 17):
        down[lane, ng + rng.choice(nl, 2, replace=False)] = True
    pd = sys_.load_pd.numpy().astype(np.float64)
    hint = pd * (1.0 + np.arange(pd.shape[0]) % 3)
    return (torch.as_tensor(down, device=sys_.device),
            sys_.load_pd[None, :].expand(n, sys_.n_load),
            (hint / hint.sum()).astype(np.float32))


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _digest(sys_, name, hint_rows=True, **kw) -> str:
    """The digest ``name`` of ``DIGESTS``; ``hint_rows`` hands
    ``certify_states`` the hint as [B, n_load] rows (else as [n_load])."""
    down, load, hint = _stressed(sys_)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the digests' thread count
    try:
        if name == "screened":
            res, n_over = dcopf.evaluate_states_screened(
                sys_, down, load, 32, repair_buffer=256, shed_hint=hint)
            return _sha(list(res) + [n_over])
        hinted, rbuf, wk = CERTIFY_CASES[name]
        h = torch.as_tensor(hint) if hinted else None
        if h is not None and hint_rows:
            h = h[None, :].expand(load.shape)
        return _sha(dcopf.certify_states(sys_, down, load, shed_hint=h,
                                         repair_buffer=rbuf, woodbury_k=wk,
                                         **kw))
    finally:
        torch.set_num_threads(threads)


# -- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_eager_path_keeps_its_bits(rts24_cpu, name):
    assert _digest(rts24_cpu, name) == DIGESTS[name]


@pytest.mark.parametrize("name", ["hinted"])
def test_hint_as_one_row_gives_the_same_bits(rts24_cpu, name):
    # The screened evaluator hands the hint over as [n_load]; the pass
    # expands it to every lane itself.
    assert _digest(rts24_cpu, name, hint_rows=False) == DIGESTS[name]
    assert _digest(rts24_cpu, name, hint_rows=False,
                   chain=graphs.EAGER) == DIGESTS[name]


class _StaticChain:
    """A graph chain's contract on the CPU: each call copies its inputs
    into the same static tensors, runs the segment on them, and writes
    its outputs into the same static tensors, which it returns."""

    graphed = True

    def __init__(self):
        self.names, self.inputs, self.outputs = [], None, None

    def run(self, name, fn, *inputs):
        self.names.append(name)
        if self.inputs is None:
            self.inputs = tuple(t.clone() for t in inputs)
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        out = tuple(fn(*self.inputs))
        if self.outputs is None:
            self.outputs = tuple(torch.empty_like(o) for o in out)
        for static, o in zip(self.outputs, out):
            static.copy_(o)
        return self.outputs

    def fresh(self, t):
        return t.clone()


def _screened(sys_, batches, hint):
    return [dcopf.evaluate_states_screened(
        sys_, d, l, 32, repair_buffer=256, shed_hint=hint)[0]
        for d, l in batches]


def test_screened_results_outlive_the_next_call(rts24_cpu, monkeypatch):
    # Three calls through a chain whose outputs the next call overwrites,
    # all results kept, against the eager calls: a result that aliased
    # the certificate's static outputs would differ. The chain sees one
    # segment a call, with the states, the loads and the [n_load] hint.
    batches = []
    for seed in (5, 6, 7):
        down, load, hint = _stressed(rts24_cpu, n=512, seed=seed)
        batches.append((down, load))
    chain = _StaticChain()
    seen = []

    def tier1_chain(sys_, device, lanes, repair_iters, repair_buffer,
                    woodbury_k, hinted):
        seen.append((lanes, repair_iters, repair_buffer, woodbury_k, hinted))
        return chain

    monkeypatch.setattr(dcopf, "tier1_chain", tier1_chain)
    first = _screened(rts24_cpu, batches[:1], hint)[0]
    kept = [t.clone() for t in first]
    chained = [first] + _screened(rts24_cpu, batches[1:], hint)
    assert chain.names == ["certify"] * 3
    assert seen == [(512, 3, 256, 2, True)] * 3
    assert [t.shape for t in chain.inputs] == [
        (512, rts24_cpu.n_comp), (512, rts24_cpu.n_load),
        (rts24_cpu.n_load,)]
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    monkeypatch.undo()
    eager = _screened(rts24_cpu, batches, hint)
    for g, e in zip(chained, eager):
        for f in FIELDS:
            assert torch.equal(getattr(g, f), getattr(e, f)), f
    assert any(bool(e.dns_mw.gt(0).any()) for e in eager)


def test_only_the_screened_pass_takes_a_chain(rts24_cpu, monkeypatch):
    # calibrate_shed_hint's passes and _finalize's certificate pass
    # (inside the LP tier's finalize graph on the card) stay eager.
    chain = _StaticChain()
    monkeypatch.setattr(dcopf, "tier1_chain", lambda *a, **k: chain)
    orig = dcopf.certify_states
    calls = []

    def certify_states(*a, chain=graphs.EAGER, **k):
        calls.append(chain)
        return orig(*a, chain=chain, **k)

    monkeypatch.setattr(dcopf, "certify_states", certify_states)
    down, load, hint = _stressed(rts24_cpu, n=256)
    dcopf.evaluate_states_screened(rts24_cpu, down, load, 32,
                                   repair_buffer=256, shed_hint=hint)
    assert calls == [chain, graphs.EAGER]
    calls.clear()
    dcopf.evaluate_states(rts24_cpu, down[:32], load[:32])
    assert calls == [graphs.EAGER]
    calls.clear()
    dcopf.calibrate_shed_hint(rts24_cpu, batch=512)
    assert calls and all(c is graphs.EAGER for c in calls)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    monkeypatch.setattr(dcopf, "_tier1_chains",
                        graphs.ChainCache(dcopf.TIER1_CHAINS))
    return torch.device("cuda")


def _seq_blocks(sys_, n=3, years=4, seed=2026):
    """``n`` consecutive RTS-24 SEQ year blocks of ``years`` years as the
    study's step hands them to the screened evaluator: (hour-states
    [years * 8736, n_comp], loads)."""
    hours = 8736
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    load = hl2_seq.year_block_load(sys_, load_profile.load_factors(hours),
                                   years)
    return [(hl2_seq.sample_years(
        hl2_nsq.batch_generator(seed, i, sys_.device), sys_, years, hours,
        k).transpose(1, 2).reshape(years * hours, -1), load)
        for i in range(n)]


def _seq_eval(sys_, blocks):
    lanes = blocks[0][0].shape[0]
    return [dcopf.evaluate_states_screened(
        sys_, d, l, 1024, repair_buffer=max(4096, lanes // 16))
        for d, l in blocks]


def _nsq_eval(sys_, batch=8192, seed=11):
    hint = torch.as_tensor(dcopf.calibrate_shed_hint(sys_),
                           device=sys_.device)
    down = sample_states(hl2_nsq.batch_generator(seed, 0, sys_.device),
                         sys_.unavail, sys_.always_up_nsq, batch)
    load = sys_.load_pd[None, :].expand(batch, sys_.n_load)
    return [dcopf.evaluate_states_screened(
        sys_, down, load, 2048, shed_hint=hint,
        repair_buffer=dcopf.default_repair_buffer(batch, hinted=True))]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _eager(monkeypatch):
    monkeypatch.setattr(dcopf, "tier1_chain", lambda *a, **k: graphs.EAGER)


def _assert_equal(graphed, eager):
    for (g, g_over), (e, e_over) in zip(graphed, eager):
        assert torch.equal(g_over, e_over)
        for f in FIELDS:
            assert torch.equal(_bits(getattr(g, f)), _bits(getattr(e, f))), f


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["seq_y4", "nsq8192_hint"])
def test_graph_path_is_bit_equal_to_eager(cuda, kind, monkeypatch):
    # Every result kept, then the same through the eager pass: a stale
    # static input, or a result read from outputs a later replay
    # overwrote, would differ.
    sys_ = build_system(cases.rts24(), device=cuda)
    if kind == "seq_y4":
        blocks = _seq_blocks(sys_)
        assert blocks[0][0].shape[0] == 34944

        def run():
            return _seq_eval(sys_, blocks)
    else:
        def run():
            return _nsq_eval(sys_)
    graphed = run()
    assert len(dcopf._tier1_chains) == 1
    (chain,) = dcopf._tier1_chains._chains.values()
    assert list(chain.segments) == ["certify"]
    _eager(monkeypatch)
    eager = run()
    torch.cuda.synchronize()
    _assert_equal(graphed, eager)
    assert any(bool(e.dns_mw.gt(0).any()) for e, _ in eager)


@pytest.mark.gpu
def test_results_outlive_the_next_replay(cuda):
    sys_ = build_system(cases.rts24(), device=cuda)
    blocks = _seq_blocks(sys_, n=2)
    first = _seq_eval(sys_, blocks[:1])[0]
    torch.cuda.synchronize()
    kept = [t.clone() for t in first[0]]
    _seq_eval(sys_, blocks[1:])
    torch.cuda.synchronize()
    for a, b in zip(first[0], kept):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
def test_one_replay_a_call(cuda, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    sys_ = build_system(cases.rts24(), device=cuda)
    blocks = _seq_blocks(sys_)
    _seq_eval(sys_, blocks[:1])                  # captures
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        _seq_eval(sys_, blocks)
        torch.cuda.synchronize()
    got = profiling.counters()
    profiling.reset_counters()
    assert got["tier1.graph_replays"] == 3
    assert "tier1.graph_captures" not in got
    assert got["span_ns.tier1.replay"] > 0
    _eager(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        _seq_eval(sys_, blocks[:1])
    got = profiling.counters()
    profiling.reset_counters()
    assert "tier1.graph_replays" not in got


@pytest.mark.gpu
def test_capture_under_a_profiler(cuda, monkeypatch):
    # A study profiled from its start captures inside the profiler: the
    # graph still gives the eager bits, and the counters see one capture
    # and one replay.
    from torch.profiler import ProfilerActivity, profile
    sys_ = build_system(cases.rts24(), device=cuda)
    blocks = _seq_blocks(sys_, n=1)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        graphed = _seq_eval(sys_, blocks)
        torch.cuda.synchronize()
    got = profiling.counters()
    profiling.reset_counters()
    assert got["tier1.graph_captures"] == 1
    assert got["tier1.graph_replays"] == 1
    _eager(monkeypatch)
    _assert_equal(graphed, _seq_eval(sys_, blocks))


if __name__ == "__main__":
    sys_ = build_system(cases.rts24(), device="cpu")
    for name in sorted(DIGESTS):
        print(f'    "{name}": "{_digest(sys_, name)}",')
