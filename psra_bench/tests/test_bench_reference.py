"""The plain reference against float64 HiGHS and against the program's
own data on the CPU."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from psra_bench.reference import case as rc, draws, lp
from psra_bench.reference.evaluate import loss_of_load

ROOT = Path(__file__).resolve().parents[1]


def _cfg(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def _states(case, n, seed, boost=8.0):
    rng = np.random.default_rng(seed)
    down = rng.random((n, case.n_comp)) < np.minimum(case.unavail * boost,
                                                     0.5)
    down[:, case.pinned_nsq] = False
    load = np.tile(case.bus_pd[case.load_bus], (n, 1)) * rng.uniform(
        0.7, 1.0, (n, 1))
    return down, load


def _highs(case, down, load):
    """Float64 HiGHS optimum (MW) of the same LP, theta free."""
    nb, ng, nd, nl = case.n_bus, case.n_gen, case.n_load, case.n_branch
    inc, base = rc.incidence(case), case.base_mva
    out = []
    for dn, ld in zip(down, load):
        up = (~dn).astype(float)
        A = np.zeros((nb + nl, ng + nd + nl + nb))
        A[case.gen_bus, np.arange(ng)] = 1
        A[case.load_bus, ng + np.arange(nd)] = 1
        A[:nb, ng + nd:ng + nd + nl] = -inc.T
        A[nb + np.arange(nl), ng + nd + np.arange(nl)] = case.br_x
        A[nb:, ng + nd + nl:] = -up[ng:, None] * inc
        b = np.zeros(nb + nl)
        b[case.load_bus] = ld / base
        c = np.zeros(A.shape[1])
        c[ng:ng + nd] = 1
        bounds = ([(0, case.gen_pmax[g] / base * up[g]) for g in range(ng)]
                  + [(0, x / base) for x in ld]
                  + [(-r / base, r / base) for r in case.br_rate]
                  + [(0, 0)] + [(None, None)] * (nb - 1))
        r = linprog(c, A_eq=A, b_eq=b, bounds=bounds, method="highs")
        assert r.status == 0, r.message
        out.append(r.fun * base)
    return np.asarray(out)


@pytest.mark.parametrize("n,seed", [(96, 1), (48, 2)])
def test_lp_matches_highs(n, seed):
    case = rc.from_config(_cfg("rts24"))
    down, load = _states(case, n, seed=seed)
    got = lp.min_shed(case, torch.as_tensor(down), torch.as_tensor(load),
                      lp.Precision("float64"))[0].sum(1).numpy()
    want = _highs(case, down, load)
    assert (want > 1e-3).sum() > n // 4
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# States whose LP degenerates (a radial unit bus islanded, parallel
# outages): the normal equations lose their conditioning once converged.
HARD = [[23, 43], [38, 59], [7, 32, 43], [4, 38, 59], [16, 32, 56, 60],
        [0, 5, 15, 32, 43], [21, 32, 43], [11, 12, 43]]


def test_lp_matches_highs_on_degenerate_states():
    case = rc.from_config(_cfg("rts24"))
    down = np.zeros((len(HARD), case.n_comp), bool)
    for i, comps in enumerate(HARD):
        down[i, comps] = True
    load = np.tile(case.bus_pd[case.load_bus], (len(HARD), 1))
    got, merit = lp.min_shed(case, torch.as_tensor(down),
                             torch.as_tensor(load), lp.Precision("float64"))
    np.testing.assert_allclose(got.sum(1).numpy(), _highs(case, down, load),
                               atol=1e-3, rtol=0)
    assert merit < 1e-8


def test_zero_shed_certificate_agrees_with_lp():
    case = rc.from_config(_cfg("rts24"))
    down, load = _states(case, 200, seed=2, boost=2.0)
    f64 = lp.Precision("float64")
    dns, _, n_lp, _ = loss_of_load(case, torch.as_tensor(down),
                                   torch.as_tensor(load), f64)
    assert n_lp < 200
    full = lp.min_shed(case, torch.as_tensor(down), torch.as_tensor(load),
                       f64)[0].sum(1)
    full = torch.where(full < 0.1, 0.0, full)
    np.testing.assert_allclose(dns.numpy(), full.numpy(), atol=1e-5)


def test_tf32_control_departs():
    case = rc.from_config(_cfg("rts24"))
    down, load = _states(case, 64, seed=3)
    args = (case, torch.as_tensor(down), torch.as_tensor(load))
    ref = lp.min_shed(*args, lp.Precision("float64"))[0].sum(1)
    ctl = lp.min_shed(*args, lp.Precision("tf32"))[0].sum(1).double()
    assert float((ctl - ref).abs().max()) > 0.5


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.0], dtype=torch.float32)
    got = lp.Precision("tf32").round(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0, 3.0]


# RTS-79 Table 12's outage durations (h) of lines 3-9, the 3-24
# transformer, 4-9, 5-10 and the 6-10 cable, branches 5-9. The program's
# own case (after case24_failrate.m) shifts them; the harness hands the
# program the configuration's case.
TABLE12_DUR = [10.0, 768.0, 10.0, 10.0, 35.0]
PROGRAM_DUR = [768.0, 10.0, 10.0, 35.0, 10.0]


def test_config_holds_the_programs_case():
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    want = cases.rts24()
    got = _cfg("rts24")["case"]
    for k in ("bus_pd", "gen_bus", "gen_pmax", "gen_mttf", "gen_mttr",
              "br_from", "br_to", "br_x", "br_rate", "br_lambda"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(getattr(want, k)), k)
    dur = np.asarray(got["br_dur"])
    np.testing.assert_array_equal(dur[5:10], TABLE12_DUR)
    np.testing.assert_array_equal(np.asarray(want.br_dur)[5:10], PROGRAM_DUR)
    keep = np.r_[0:5, 10:dur.size]
    np.testing.assert_array_equal(dur[keep], np.asarray(want.br_dur)[keep])


def test_load_factors_and_draws_match_the_program():
    from powersystemsreliabilityassessment_tpu_torch.core import load_profile
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from psra_bench.studies.common import case_data
    cfg = _cfg("rts24")
    case = rc.from_config(cfg)
    np.testing.assert_array_equal(rc.load_factors(case, 8736),
                                  load_profile.load_factors(8736))
    mt = twostate.mean_times(case_data(cfg))
    assert draws.num_draws(case, 8736) == chronological.default_num_draws(
        mt[:, 0], mt[:, 1], 8736)
    np.testing.assert_array_equal(case.unavail,
                                  twostate.unavailability(case_data(cfg)))


def test_seq_states_match_the_programs_draw():
    """The reference's year block is the study's, hour for hour, on the
    study's own generator (the CPU's Mersenne Twister here)."""
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, hl2_seq)
    from psra_bench.studies.common import case_data
    cfg = _cfg("rts24")
    case = rc.from_config(cfg)
    sys_ = build_system(case_data(cfg), device="cpu")
    K = draws.num_draws(case, 8736)
    got = hl2_seq.sample_years(hl2_nsq.batch_generator(77, 5, "cpu"), sys_,
                               2, 8736, K)
    want = draws.seq_states(case, 77, 5, 2, 8736, K, "cpu")
    assert torch.equal(got.transpose(1, 2), want)
