"""PyTorch port: the whole-certificate kernel K5
(``ops/certify_kernel.py::certify_states_fused``), its plain version on
the CPU (the port's ``certify_states(woodbury_k=2)``), against the
reference's ``certify_states_fused`` run in Pallas interpret mode on the
same numpy states: outage-rich RTS-24 batches (40x and 25x
unavailability, covering n_out = 0/1/2/3+ and islanding lanes, a batch
of TILE + 17) and an RTS-96 batch at 10x. Masks must be equal;
deficits within 1e-5 p.u. (RTS-96: rtol 1e-4, as the reference's own
test, for ~90 p.u. capacity sums); shed and dispatch within 1e-5 p.u. on
lanes both certify; and the certified candidates pass an independent
float64 flow check (tests/test_certify_kernel.py:55).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.ops import (
    certify_kernel as ref_kernel)

from powersystemsreliabilityassessment_tpu_torch.core.system import (
    from_reference)
from powersystemsreliabilityassessment_tpu_torch.ops import certify_kernel
from test_torch_fused_sampler_cert import boosted_states

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

TOL_PU = 1e-5


@pytest.fixture(scope="module")
def systems():
    ref24 = ref_build_system(ref_cases.rts24())
    ref96 = ref_build_system(ref_cases.rts96())
    return {"rts24": (ref24, from_reference(ref24, device="cpu")),
            "rts96": (ref96, from_reference(ref96, device="cpu"))}


CASES = {   # name: (system, lanes, boost, seed, deficit tolerances)
    "rts24_1024": ("rts24", 1024, 40.0, 7, dict(rtol=0, atol=TOL_PU)),
    "rts24_tile_plus_17": ("rts24", ref_kernel.TILE + 17, 25.0, 3,
                           dict(rtol=0, atol=TOL_PU)),
    "rts96_256": ("rts96", 256, 10.0, 5, dict(rtol=1e-4, atol=1e-4)),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request, systems):
    name, B, boost, seed, dtol = CASES[request.param]
    ref_sys, sys_ = systems[name]
    down = boosted_states(ref_sys, B, seed, boost)
    load = np.tile(np.asarray(ref_sys.load_pd)[None, :], (B, 1))
    want = ref_kernel.certify_states_fused(ref_sys, jnp.asarray(down),
                                           jnp.asarray(load))
    got = certify_kernel.certify_states_fused(
        sys_, torch.as_tensor(down), torch.as_tensor(load))
    return ref_sys, down, load, want, got, dtol


def test_matches_reference_kernel(pair):
    ref_sys, down, _, want, got, dtol = pair
    wc, gc = np.asarray(want.certified), got.certified.numpy()
    assert gc.shape == (down.shape[0],)
    np.testing.assert_array_equal(gc, wc)
    assert 0.3 < gc.mean() < 1.0           # both tiers are exercised
    np.testing.assert_allclose(got.deficit.numpy(),
                               np.asarray(want.deficit), **dtol)
    both = wc & gc
    np.testing.assert_allclose(got.shed.numpy()[both],
                               np.asarray(want.shed)[both], rtol=0,
                               atol=TOL_PU)
    np.testing.assert_allclose(got.dispatch.numpy()[both],
                               np.asarray(want.dispatch)[both], rtol=0,
                               atol=TOL_PU)


def test_certified_candidates_are_feasible(pair):
    ref_sys, down, load, _, got, _ = pair
    f64 = lambda a: np.asarray(a, np.float64)
    c = got.certified.numpy()
    shed, disp = f64(got.shed.numpy()), f64(got.dispatch.numpy())
    loh = f64(ref_sys.load_onehot)
    inj = disp @ f64(ref_sys.gen_bus_onehot).T + shed @ loh.T - load @ loh.T
    f = inj @ f64(ref_sys.ptdf).T
    brd = down[:, ref_sys.n_gen:].astype(np.float64)
    post = (f + (brd * f) @ f64(ref_sys.lodf).T) * (1.0 - brd)
    ok1 = (np.abs(post) <= f64(ref_sys.br_rate)[None, :] + 2e-4).all(1)
    # Intact and single-outage lanes: the LODF-corrected check is exact.
    sel = c & (brd.sum(1) <= 1)
    assert sel.sum() > 100
    assert ok1[sel].all()
    # The certificate's shed totals the copper bound on certified lanes.
    np.testing.assert_allclose(shed[c].sum(1), f64(got.deficit.numpy())[c],
                               atol=1e-4)
