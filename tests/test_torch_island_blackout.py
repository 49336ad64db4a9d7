"""PyTorch port: ``CompatFlags(island_blackout=True)`` (loads cut off from
bus 0 shed outright, their island's generators out) against the JAX
package on the CPU.

* ``connected_to_ref`` and ``apply_island_blackout`` on random
  branch-outage states of RTS-24 and RTS-96: equal (0/1 arithmetic).
* tests/test_lp_dcopf.py's ``TestIslandBlackout`` through the port: line
  7-8 out sheds bus 7's 125 MW, the intact state nothing, and without the
  flag the same state sheds nothing.
* ``evaluate_states`` and ``evaluate_states_screened`` with the flag on
  RTS-24 states with each branch out at 8% (islands in some of them):
  DNS per lane within 0.05 MW, the same failure flags, nodal shed within
  0.05 MW per bus.
* A fault of the reference: on a 72-bus ring with one branch out (a
  71-hop path) the port reaches every bus, while the reference's fixed 5
  squarings (paths of at most 32 hops) report the far buses cut off.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import dcopf as ref_dcopf
from powersystemsreliabilityassessment_tpu.utils import config as ref_config

from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system, from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig)
from test_torch_gpu import k4_limit_case

torch.set_num_threads(1)

BLACKOUT = CompatFlags(island_blackout=True)
REF_BLACKOUT = ref_config.CompatFlags(island_blackout=True)
REF_IPM = ref_config.IPMConfig()
ORACLE_TOL_MW = 0.05   # the port's DNS parity bound (tests/test_torch_nsq.py)


@pytest.fixture(scope="module")
def systems():
    out = {}
    for name in ("rts24", "rts96"):
        ref_sys = ref_build_system(getattr(ref_cases, name)())
        out[name] = (ref_sys, from_reference(ref_sys, device="cpu"))
    return out


def _states(ref_sys, batch, seed, p_branch=0.08):
    """Sampled states, each branch out with probability ``p_branch`` (so
    that many of them island), the units at their unavailability; the
    sync condenser stays up."""
    rng = np.random.default_rng(seed)
    u = np.asarray(ref_sys.unavail, np.float64).copy()
    u[ref_sys.n_gen:] = p_branch
    down = rng.uniform(size=(batch, u.shape[0])) < u[None, :]
    down &= ~np.asarray(ref_sys.always_up_nsq)[None, :]
    return down


def _loads(ref_sys, batch):
    return np.tile(np.asarray(ref_sys.load_pd)[None], (batch, 1))


@pytest.mark.parametrize("name", ["rts24", "rts96"])
@pytest.mark.parametrize("p_out", [0.05, 0.3])
def test_connected_to_ref_matches_reference(systems, name, p_out):
    ref_sys, sys_ = systems[name]
    rng = np.random.default_rng(int(p_out * 100) + sys_.n_bus)
    br_up = (rng.uniform(size=(64, sys_.n_branch)) >= p_out).astype(
        np.float32)
    got = dcopf.connected_to_ref(sys_, torch.as_tensor(br_up)).numpy()
    want = np.asarray(ref_dcopf.connected_to_ref(ref_sys,
                                                 jnp.asarray(br_up)))
    np.testing.assert_array_equal(got, want)
    assert not got.all()          # some buses are cut off
    assert got[:, 0].all()        # bus 0 reaches itself


@pytest.mark.parametrize("name", ["rts24", "rts96"])
def test_apply_island_blackout_matches_reference(systems, name):
    ref_sys, sys_ = systems[name]
    down = _states(ref_sys, 64, seed=3, p_branch=0.15)
    loads = _loads(ref_sys, 64) * np.random.default_rng(4).uniform(
        0.8, 1.2, size=(64, 1))
    loads = loads.astype(np.float32)
    got = dcopf.apply_island_blackout(sys_, torch.as_tensor(down),
                                      torch.as_tensor(loads))
    want = ref_dcopf.apply_island_blackout(ref_sys, jnp.asarray(down),
                                           jnp.asarray(loads))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-4)
    assert (got[2].numpy().sum(1) > 0).any()   # some load is islanded


def test_blackout_sheds_the_island_of_bus_7(systems):
    # tests/test_lp_dcopf.py::TestIslandBlackout through the port.
    _, sys_ = systems["rts24"]
    down = torch.zeros((2, 71), dtype=torch.bool)
    down[0, 33 + 10] = True          # line 7-8 out: bus 7 islands
    loads = sys_.load_pd[None, :].expand(2, sys_.n_load)
    res = dcopf.evaluate_states(sys_, down, loads, BLACKOUT, IPMConfig())
    assert float(res.dns_mw[0]) == pytest.approx(125.0, abs=1.0)
    assert float(res.nodal_mw[0, 6]) == pytest.approx(125.0, abs=1.0)
    assert bool(res.failure[0]) and not bool(res.failure[1])
    assert float(res.dns_mw[1]) == 0.0
    res0 = dcopf.evaluate_states(sys_, down, loads, CompatFlags(),
                                 IPMConfig())
    assert float(res0.dns_mw[0]) == 0.0
    scr, n_over = dcopf.evaluate_states_screened(sys_, down, loads, 2,
                                                 BLACKOUT, IPMConfig())
    assert int(n_over) == 0
    assert float(scr.dns_mw[0]) == pytest.approx(125.0, abs=1.0)
    br_up = torch.ones((2, 38))
    br_up[1, 10] = 0.0
    reach = dcopf.connected_to_ref(sys_, br_up)
    assert bool(reach[0].all())
    assert not bool(reach[1, 6])
    assert bool(reach[1, [0, 1, 2, 7, 23]].all())


@pytest.fixture(scope="module")
def blackout_batch(systems):
    ref_sys, sys_ = systems["rts24"]
    down = _states(ref_sys, 32, seed=11)
    down[0] = False
    down[0, 33 + 10] = True
    return ref_sys, sys_, down, _loads(ref_sys, 32)


def _assert_same(got, want):
    dns, dns_ref = got.dns_mw.numpy(), np.asarray(want.dns_mw)
    assert np.abs(dns - dns_ref).max() <= ORACLE_TOL_MW
    np.testing.assert_array_equal(got.failure.numpy(),
                                  np.asarray(want.failure))
    np.testing.assert_allclose(got.nodal_mw.numpy(),
                               np.asarray(want.nodal_mw), atol=ORACLE_TOL_MW)


def test_evaluate_states_with_blackout_matches_reference(blackout_batch):
    ref_sys, sys_, down, loads = blackout_batch
    got = dcopf.evaluate_states(sys_, torch.as_tensor(down),
                                torch.as_tensor(loads), BLACKOUT,
                                IPMConfig())
    want = ref_dcopf.evaluate_states(ref_sys, jnp.asarray(down),
                                     jnp.asarray(loads), REF_BLACKOUT,
                                     REF_IPM)
    _assert_same(got, want)
    islanded = ~dcopf.connected_to_ref(
        sys_, 1.0 - torch.as_tensor(down[:, 33:]).float()).all(1)
    assert 4 <= int(islanded.sum()) < 32


@pytest.mark.parametrize("nodal_mode", ["lp", "proportional"])
def test_screened_with_blackout_matches_reference(blackout_batch,
                                                  nodal_mode):
    ref_sys, sys_, down, loads = blackout_batch
    got, over = dcopf.evaluate_states_screened(
        sys_, torch.as_tensor(down), torch.as_tensor(loads), 32, BLACKOUT,
        IPMConfig(), nodal_mode)
    want, over_ref = ref_dcopf.evaluate_states_screened(
        ref_sys, jnp.asarray(down), jnp.asarray(loads), 32, REF_BLACKOUT,
        REF_IPM, nodal_mode)
    assert int(over) == int(over_ref) == 0
    if nodal_mode == "lp":
        _assert_same(got, want)
    else:
        # Proportional mode: totals and flags; the nodal split of
        # certified deficit lanes is the certificate's pattern.
        assert np.abs(got.dns_mw.numpy()
                      - np.asarray(want.dns_mw)).max() <= ORACLE_TOL_MW
        np.testing.assert_array_equal(got.failure.numpy(),
                                      np.asarray(want.failure))


def test_screened_with_blackout_refuses_a_precomputed_certificate(
        blackout_batch):
    _, sys_, down, loads = blackout_batch
    d, l = torch.as_tensor(down), torch.as_tensor(loads)
    pre = dcopf.certify_states(sys_, d, l)
    with pytest.raises(ValueError, match="island_blackout"):
        dcopf.evaluate_states_screened(sys_, d, l, 32, BLACKOUT,
                                       IPMConfig(), pre=pre)


def test_ring_reaches_every_bus_where_the_reference_does_not():
    # A fault of the reference: its 5 squarings cover 32 hops. A 72-bus
    # ring with branch 0 (bus 0 - bus 1) out is a 71-hop path.
    case = k4_limit_case(n_bus=72, n_units=8)
    ref_case = ref_cases.CaseData(**dataclasses.asdict(case))
    ref_sys = ref_build_system(ref_case)
    sys_ = build_system(case, device="cpu")
    br_up = np.ones((2, 72), np.float32)
    br_up[1, 0] = 0.0
    got = dcopf.connected_to_ref(sys_, torch.as_tensor(br_up)).numpy()
    want = np.asarray(ref_dcopf.connected_to_ref(ref_sys,
                                                 jnp.asarray(br_up)))
    assert got.all()
    assert not want[1].all()                       # the reference's fault
    hops = np.minimum(np.arange(72), 72 - np.arange(72))
    assert (~want[0] == (hops > 32)).all()         # intact: beyond 32 hops
    down = np.zeros((2, sys_.n_comp), bool)
    down[1, sys_.n_gen] = True
    _, load2, nodal = dcopf.apply_island_blackout(
        sys_, torch.as_tensor(down),
        sys_.load_pd[None, :].expand(2, sys_.n_load))
    assert float(nodal.sum()) == 0.0               # nothing is islanded
    assert torch.equal(load2, sys_.load_pd[None, :].expand(2, sys_.n_load))
