"""PyTorch port: the tier-1 certificate (``certify_states``) against the
JAX reference on identical numpy states, and the port's shed-hint
calibration.

Deficit optima at RTS-24 bind a line limit with exactly zero margin, and
the flow check is ``|post_flows| <= rate + 1e-4``: float32 sums taken in
another order can flip a few lanes' certified status between the two
packages. So the mask must agree on >= 99.9% of lanes, not bit for bit;
deficits (no flow arithmetic) agree on every lane, and shed and dispatch
on lanes both packages certify, within 1e-5 p.u. (0.001 MW, float32
rounding of O(1) p.u. sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import dcopf as ref_dcopf

from powersystemsreliabilityassessment_tpu_torch.core.system import (
    from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

TOL_PU = 1e-5
MIN_AGREE = 0.999


@pytest.fixture(scope="module")
def setup():
    ref_sys = ref_build_system(ref_cases.rts24())
    sys_ = from_reference(ref_sys, device="cpu")
    ng, nl, nc = ref_sys.n_gen, ref_sys.n_branch, ref_sys.n_comp
    rng = np.random.default_rng(11)
    u = np.asarray(ref_sys.unavail)
    # tests/test_ipm_fused.py's stressed states (3x unavailability, single
    # line outages sprinkled on every third lane) ...
    down = rng.uniform(size=(4096, nc)) < 3 * u[None, :]
    down[:, 14] = False
    rows = np.arange(0, 4096, 3)
    down[rows, ng + rng.integers(0, nl, len(rows))] = True
    # ... plus every N-1 branch outage and 200 random N-2 pairs, intact
    # generation (the Woodbury rank-2 certificate's lanes).
    n1 = np.zeros((nl, nc), bool)
    n1[np.arange(nl), ng + np.arange(nl)] = True
    n2 = np.zeros((200, nc), bool)
    for i in range(200):
        n2[i, ng + rng.choice(nl, 2, replace=False)] = True
    down = np.concatenate([down, n1, n2])
    load = np.tile(np.asarray(ref_sys.load_pd)[None, :], (down.shape[0], 1))
    hint = ref_dcopf.calibrate_shed_hint(ref_sys, batch=4096)
    assert hint is not None
    return ref_sys, sys_, down, load, hint


@pytest.mark.parametrize("hinted,repair_buffer",
                         [(False, None), (True, None), (True, 512)])
def test_certify_matches_reference(setup, hinted, repair_buffer):
    ref_sys, sys_, down, load, hint = setup
    hint_b = (np.tile(hint[None, :], (load.shape[0], 1)) if hinted
              else None)
    ref = ref_dcopf.certify_states(
        ref_sys, jnp.asarray(down), jnp.asarray(load),
        shed_hint=None if hint_b is None else jnp.asarray(hint_b),
        repair_buffer=repair_buffer)
    got = dcopf.certify_states(
        sys_, torch.as_tensor(down), torch.as_tensor(load),
        shed_hint=None if hint_b is None else torch.as_tensor(hint_b),
        repair_buffer=repair_buffer)
    rc = np.asarray(ref.certified)
    gc = got.certified.numpy()
    assert (rc == gc).mean() >= MIN_AGREE
    assert 0.5 < rc.mean() < 1.0            # a real mix of both tiers
    np.testing.assert_allclose(got.deficit.numpy(), np.asarray(ref.deficit),
                               rtol=0, atol=TOL_PU)
    both = rc & gc
    np.testing.assert_allclose(got.shed.numpy()[both],
                               np.asarray(ref.shed)[both], rtol=0,
                               atol=TOL_PU)
    np.testing.assert_allclose(got.dispatch.numpy()[both],
                               np.asarray(ref.dispatch)[both], rtol=0,
                               atol=TOL_PU)


def test_woodbury_rank2_certifies_n2_lanes(setup):
    ref_sys, sys_, down, load, _ = setup
    n2 = down[-200:]
    ref = ref_dcopf.certify_states(ref_sys, jnp.asarray(n2),
                                   jnp.asarray(load[-200:]))
    got = dcopf.certify_states(sys_, torch.as_tensor(n2),
                               torch.as_tensor(load[-200:]))
    assert got.certified.numpy().sum() > 100
    assert (np.asarray(ref.certified) == got.certified.numpy()).mean() \
        >= MIN_AGREE


def test_shed_hint_calibration(setup):
    # The port samples its own calibration batch (Philox / MT streams
    # differ from threefry), so its pattern is held to the contract, not
    # to the reference's numbers. When the tightened harvest rescues only
    # zero-deficit lanes (the reference's own draw at the default batch
    # does), the port falls back to the real ratings instead of
    # returning None.
    _, sys_, _, _, _ = setup
    hint = dcopf.calibrate_shed_hint(sys_)
    assert hint is not None and hint.shape == (sys_.n_load,)
    assert hint.dtype == np.float32
    assert abs(float(hint.sum()) - 1.0) < 1e-5 and (hint >= 0).all()


@pytest.mark.parametrize("batch,hinted", [(4096, False), (262144, True),
                                          (262144, False)])
def test_default_repair_buffer_matches_reference(batch, hinted):
    assert dcopf.default_repair_buffer(batch, hinted=hinted) == \
        ref_dcopf.default_repair_buffer(batch, hinted=hinted)
    assert dcopf.default_repair_buffer(batch, 2.0) is None
