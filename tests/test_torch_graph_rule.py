"""The one rule that picks a CUDA graph chain or the eager calls
(``runtime/graphs.chain_for``), through each layer that asks it: the
m <= 72 LP tier (``engines/lp_ipm_structured.lp_chain``, at most
``GRAPH_MAX_LANES`` lanes) and the screened evaluator's tier-1 pass
(``engines/dcopf.tier1_chain``, no lane cap). On the CPU, with a stand-in
for the capture test: a chain only on a CUDA device, on a route whose
``graphs`` is set, within the layer's lane cap and while no capture is
under way; the cache key; each layer's bounded cache; the cache's LRU
order and the eager stand-in.
"""
from types import SimpleNamespace

import pytest
import torch

from powersystemsreliabilityassessment_tpu_torch.engines import (
    dcopf, lp_ipm_structured as ls)
from powersystemsreliabilityassessment_tpu_torch.ops import batched_chol
from powersystemsreliabilityassessment_tpu_torch.runtime import graphs
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)

CUDA0 = torch.device("cuda", 0)
# (n_bus, n_branch) of a system whose LP has m rows.
DIMS = {191: (72, 119), 792: (300, 492)}
RTS24_DIMS = SimpleNamespace(n_bus=24, n_branch=38)
LP_KEY = ("solve", 1, IPMConfig(), 16)


@pytest.fixture
def chains(monkeypatch):
    """Fresh chain caches for both layers, and no capture under way."""
    monkeypatch.setattr(ls, "_chains", graphs.ChainCache(ls.GRAPH_CHAINS))
    monkeypatch.setattr(dcopf, "_tier1_chains",
                        graphs.ChainCache(dcopf.TIER1_CHAINS))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return {"lp": ls._chains, "tier1": dcopf._tier1_chains}


def _lp(device=CUDA0, m=62, lanes=1024, key=LP_KEY):
    return ls.lp_chain(key, device, m, lanes, None)


def _tier1(device=CUDA0, m=62, lanes=34944, repair_iters=3,
           repair_buffer=4096, woodbury_k=2, hinted=False, sys_=None):
    if sys_ is None:
        sys_ = (RTS24_DIMS if m == 62
                else SimpleNamespace(n_bus=DIMS[m][0], n_branch=DIMS[m][1]))
    return dcopf.tier1_chain(sys_, device, lanes, repair_iters,
                             repair_buffer, woodbury_k, hinted)


LAYERS = {"lp": _lp, "tier1": _tier1}
SIZES = {"lp": ls.GRAPH_CHAINS, "tier1": dcopf.TIER1_CHAINS}


@pytest.mark.parametrize("layer, device, m, lanes", [
    ("lp", "cpu", 62, 1024),                    # CPU tensors
    ("lp", CUDA0, 80, 1024),                    # m > 72: the blocked route
    ("lp", CUDA0, 792, 1024),                   # m > 336: the large route
    ("lp", CUDA0, 62, ls.GRAPH_MAX_LANES + 1),  # above the LP tier's cap
    ("lp", CUDA0, 62, 65536),                   # the enumeration's buffer
    ("tier1", "cpu", 62, 34944),                # CPU tensors
    ("tier1", CUDA0, 191, 34944),               # m > 72: RTS-96
    ("tier1", CUDA0, 792, 8192),                # m > 336: case300s
])
def test_eager_off_the_graph_route(chains, layer, device, m, lanes):
    assert LAYERS[layer](device=device, m=m, lanes=lanes) is graphs.EAGER
    assert len(chains[layer]) == 0


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_eager_while_a_capture_is_under_way(chains, layer, monkeypatch):
    # The LP tier's finalize graph captures certify_states inside it.
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert LAYERS[layer]() is graphs.EAGER
    assert len(chains[layer]) == 0


@pytest.mark.parametrize("layer, lanes, keep, launches", [
    ("lp", (1, 1024, ls.GRAPH_MAX_LANES), None, (batched_chol.launches,)),
    # No lane cap: a 16-year SEQ block of RTS-24 is 139,776 lanes.
    ("tier1", (8192, 34944, 139776), RTS24_DIMS, ()),
])
def test_graph_chain_on_the_route(chains, layer, lanes, keep, launches):
    call = LAYERS[layer]
    for n in lanes:
        chain = call(lanes=n)
        assert isinstance(chain, graphs.Chain) and chain.graphed
        assert chain.device == CUDA0 and chain.layer == layer
        assert chain.keep is keep and chain.launches == launches
        assert chain is call(lanes=n)
    assert len(chains[layer]) == 3


@pytest.mark.parametrize("layer, change", [
    ("lp", dict(lanes=2048)),
    ("lp", dict(key=("solve", 1, IPMConfig(iterations=20), 16))),
    ("lp", dict(key=("finalize", 1, None, 2))),
    ("lp", dict(key=("solve", 2, IPMConfig(), 16))),
    ("lp", dict(device=torch.device("cuda", 1))),
    ("tier1", dict(lanes=8192)),
    ("tier1", dict(repair_buffer=2048)),
    ("tier1", dict(repair_buffer=None)),
    ("tier1", dict(woodbury_k=3)),
    ("tier1", dict(repair_iters=6)),
    ("tier1", dict(hinted=True)),
    ("tier1", dict(sys_=SimpleNamespace(n_bus=24, n_branch=38))),
    ("tier1", dict(device=torch.device("cuda", 1))),
])
def test_cache_key_separates(chains, layer, change):
    # Each call of the same arguments hits its chain; any change of what
    # fixes the chain's shapes and work makes another.
    call = LAYERS[layer]
    base = call()
    other = call(**change)
    assert isinstance(other, graphs.Chain) and other is not base
    assert call() is base and call(**change) is other
    assert len(chains[layer]) == 2


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_cache_stays_bounded_and_drops_the_least_recent(chains, layer):
    call, size = LAYERS[layer], SIZES[layer]
    first, second = call(lanes=1), call(lanes=2)
    for lanes in range(3, size + 1):
        call(lanes=lanes)
    assert call(lanes=1) is first          # now the most recent
    for lanes in range(size + 1, size + 4):
        call(lanes=lanes)
        assert len(chains[layer]) == size
    assert call(lanes=1) is first
    assert call(lanes=2) is not second


def test_chain_cache_lru_order():
    cache = graphs.ChainCache(2)
    a = cache.get("a", object)
    b = cache.get("b", object)
    assert cache.get("a", object) is a
    cache.get("c", object)
    assert "b" not in cache and "a" in cache and "c" in cache
    assert cache.get("b", object) is not b and len(cache) == 2


def test_eager_stand_in_runs_each_segment_as_a_call():
    x = torch.arange(4.0)
    out = graphs.EAGER.run("seg", lambda a, b: (a + b, a * b), x, x)
    assert isinstance(out, tuple) and len(out) == 2
    assert torch.equal(out[0], 2 * x) and torch.equal(out[1], x * x)
    assert graphs.EAGER.fresh(x) is x and not graphs.EAGER.graphed
    chain = graphs.Chain(CUDA0, "lp")
    copy = chain.fresh(x)
    assert copy is not x and torch.equal(copy, x)
