"""The port's multilevel-splitting SEQ study (studies/hl2_seq_split.py).

Every case of tests/test_seq_split.py through the port; the combine
against a float64 numpy oracle that loops over parents and counts events
hour by hour; the pilot's level and the split estimate against the
reference's (the streams differ by design, so within Monte Carlo
tolerance).

The key invariant: the split estimator is the plain one whenever no
fresh clone carries a tail, either because no year reaches the level or
because K = 1 (the only tail is the parent's own continuation). Both
runs on one seed draw the same parents, so they give equal indices,
which exercises the pre / tail decomposition of every index including
the NLC boundary rise.
"""
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.sampling import chronological
from powersystemsreliabilityassessment_tpu_torch.studies import hl2_seq_split
from powersystemsreliabilityassessment_tpu_torch.studies.hl2_seq_split import (
    SplitConfig, SplitDraw, run_seq_split_study, split_combine)
from powersystemsreliabilityassessment_tpu_torch.utils.config import MCSConfig

CPU = "cpu"


def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


def _mean_times(case):
    mt = twostate.mean_times(case)
    return (torch.as_tensor(mt[:, 0], dtype=torch.float32),
            torch.as_tensor(mt[:, 1], dtype=torch.float32), mt)


def test_from_state_up_matches_plain():
    # Starting all-UP from the same generator reproduces the continuous
    # (quantize=False) sample_timeline exactly.
    case = cases.rts24()
    mttf, mttr, mt = _mean_times(case)
    nd = chronological.default_num_draws(mt[:, 0], mt[:, 1], 336)
    a = chronological.sample_timeline(_gen(11), mttf, mttr, 336, nd,
                                      quantize=False)
    b = chronological.sample_timeline_from_state(
        _gen(11), torch.zeros(case.n_comp, dtype=torch.bool), mttf, mttr,
        336, nd)
    assert torch.equal(a, b)


def test_from_state_down_starts_down():
    case = cases.rts24()
    mttf, mttr, mt = _mean_times(case)
    nd = chronological.default_num_draws(mt[:, 0], mt[:, 1], 48)
    tl = chronological.sample_timeline_from_state(
        _gen(3), torch.ones(case.n_comp, dtype=torch.bool), mttf, mttr, 48,
        nd)
    assert bool(tl[:, 0].all())


_KW = dict(years_per_device=8, max_lp=64, hours=504, log_every=0,
           device=CPU)


def _assert_same_indices(a, b, nodal_rtol=1e-5):
    assert a.years == b.years
    assert a.eens_mwh_yr == pytest.approx(b.eens_mwh_yr, rel=1e-6)
    assert a.lole_hr_yr == pytest.approx(b.lole_hr_yr, rel=1e-9)
    assert a.lolf_occ_yr == pytest.approx(b.lolf_occ_yr, rel=1e-9)
    np.testing.assert_allclose(a.nodal_eens_mwh_yr, b.nodal_eens_mwh_yr,
                               rtol=nodal_rtol)


def test_split_estimator_reduces_to_plain():
    case = cases.rts24()
    cfg = MCSConfig(max_years=16, cov_threshold=0.0, seed=2)
    never = run_seq_split_study(
        case, cfg, SplitConfig(level_mw=-1e9, k_clones=3, max_split=2),
        **_KW)
    # Every year splits at T = 0, and the only tail is the parent's own.
    k1 = run_seq_split_study(
        case, cfg, SplitConfig(level_mw=1e9, k_clones=1, max_split=2),
        **_KW)
    assert never.split_entered == 0 and k1.split_entered == 16
    _assert_same_indices(k1, never)
    np.testing.assert_allclose(k1.comp_importance, never.comp_importance,
                               rtol=1e-5)


def test_shift_table_never_clamps():
    # The clone load-factor table keeps its 2H padding, so the H entries
    # from every split hour t <= H are the year's own hours, then zeros.
    from powersystemsreliabilityassessment_tpu.studies.hl2_seq_split import (
        _pad_shift_table as ref_pad)
    H = 8736
    fac = np.arange(H, dtype=np.float32)
    tab = hl2_seq_split._pad_shift_table(fac)
    assert tab.shape[0] >= 2 * H and tab.dtype == np.float32
    np.testing.assert_array_equal(tab, ref_pad(fac)[:tab.shape[0]])
    tab_t = torch.as_tensor(tab)
    rel = torch.arange(H)
    for t in (0, 96, 97, 5000, H - 1, H):
        got = tab_t[t + rel].numpy()
        want = np.concatenate([fac[t:], np.zeros(t, np.float32)])
        np.testing.assert_array_equal(got, want)


def test_split_runs_and_is_sane():
    r = run_seq_split_study(
        cases.rts24(), MCSConfig(max_years=16, cov_threshold=0.0, seed=2),
        SplitConfig(level_mw=400.0, k_clones=3, max_split=4), **_KW)
    assert r.years == 16
    assert r.eens_mwh_yr >= 0
    assert r.lolf_occ_yr <= r.lole_hr_yr or r.lole_hr_yr == 0
    assert len(r.annual_dlc) == len(r.annual_nlc) == 16


def test_split_auto_level_calibration(capsys):
    r = run_seq_split_study(
        cases.rts24(), MCSConfig(max_years=8, cov_threshold=0.0, seed=4),
        SplitConfig(level_mw=None, k_clones=2, max_split=2,
                    entry_target=0.25, pilot_years=128),
        **{**_KW, "years_per_device": 4, "log_every": 1})
    assert r.years == 8
    assert r.eens_mwh_yr >= 0
    # With a 25% entry target, some of the 8 parent years enter.
    assert r.split_entered >= 1
    assert "auto-calibrated splitting level" in capsys.readouterr().out


def test_split_checkpoint_resume_equals_uninterrupted(tmp_path):
    from powersystemsreliabilityassessment_tpu_torch.runtime.checkpoint import (
        Checkpointer)
    cfg = MCSConfig(max_years=12, cov_threshold=0.0, seed=9)
    kw = {**_KW, "years_per_device": 4}
    sc = SplitConfig(level_mw=600.0, k_clones=2, max_split=2)
    full = run_seq_split_study(cases.rts24(), cfg, sc, **kw)
    # Interrupted after 4 years, checkpointed every batch, then resumed.
    ck = Checkpointer(str(tmp_path / "split.ckpt"))
    run_seq_split_study(
        cases.rts24(), MCSConfig(max_years=4, cov_threshold=0.0, seed=9),
        sc, checkpointer=ck, checkpoint_every=1, **kw)
    resumed = run_seq_split_study(cases.rts24(), cfg, sc, checkpointer=ck,
                                  checkpoint_every=1, **kw)
    assert resumed.years == full.years == 12
    assert resumed.annual_ens == full.annual_ens
    assert resumed.split_entered == full.split_entered
    _assert_same_indices(resumed, full)


def test_antithetic_from_state_distribution():
    # Each antithetic draw is exactly distributed: the down fraction of
    # the generators over many pairs matches the plain draw's.
    case = cases.rts24()
    mttf, mttr, mt = _mean_times(case)
    nd = chronological.default_num_draws(mt[:, 0], mt[:, 1], 336)
    down0 = torch.zeros((64, case.n_comp), dtype=torch.bool)
    ua, ub = chronological.timeline_uniforms(_gen(5), case.n_comp, nd,
                                             (64,), device=CPU)
    frac = []
    for anti in (False, True):
        tl = chronological.timeline_from_state_uniforms(
            ua, ub, down0, mttf, mttr, 336, antithetic=anti)
        frac.append(float(tl[:, :33].float().mean()))
    assert abs(frac[0] - frac[1]) < 0.01


def test_split_k1_midyear_level_reduces_to_plain(monkeypatch):
    # K = 1 at a level entered mid-year (T > 0): the pre-split part plus
    # the parent's own tail rebuild the plain year exactly; the LOLF
    # boundary rise at T must be anchored at T, or an event straddling T
    # is counted twice. -100 MW lies inside deep-deficit events, so some
    # split hours land mid-event; the test counts them.
    case = cases.rts24()
    cfg = MCSConfig(max_years=16, cov_threshold=0.0, seed=2)
    kw = {**_KW, "load_scale": 1.2}
    never = run_seq_split_study(
        case, cfg, SplitConfig(level_mw=-1e9, k_clones=3,
                               max_split=2), **kw)
    straddles = []
    combine = hl2_seq_split.split_combine

    def counting(draw, dns_p, *a, **k):
        T = draw.T[draw.pidx][draw.psel]
        flag = dns_p[draw.pidx][draw.psel] > 0.01
        mid = (T > 0) & (T < flag.shape[1])
        i = torch.nonzero(mid).flatten()
        straddles.append(int((flag[i, T[i] - 1] & flag[i, T[i]]).sum()))
        return combine(draw, dns_p, *a, **k)

    monkeypatch.setattr(hl2_seq_split, "split_combine", counting)
    k1 = run_seq_split_study(
        case, cfg, SplitConfig(level_mw=-100.0, k_clones=1, max_split=4),
        **kw)
    assert k1.split_entered > 0 and sum(straddles) > 0
    _assert_same_indices(k1, never)


# --- the combine against a float64 oracle ---------------------------------

def _events(flags, prev=False):
    """Rising edges of a flag sequence after the flag ``prev``."""
    n = 0
    for f in flags:
        n += int(f and not prev)
        prev = f
    return n


def _oracle(draw, dns_p, nodal_p, dns_c, nodal_c, K, thresh, H):
    """Per-parent-year (ens, dlc, nlc, nodal, comp), float64, looping over
    parents and hours."""
    down = draw.down.numpy().transpose(0, 2, 1)            # [Y, H, nc]
    cdown = draw.clone_down.numpy().transpose(0, 1, 3, 2)  # [S, K-1, H, nc]
    T, pidx, psel = draw.T.numpy(), draw.pidx.numpy(), draw.psel.numpy()
    dns_p, nodal_p = dns_p.double().numpy(), nodal_p.double().numpy()
    dns_c, nodal_c = dns_c.double().numpy(), nodal_c.double().numpy()
    Y = dns_p.shape[0]

    def stats(dns, nod, dwn, prev=False):
        flag = dns > thresh
        return (dns.sum(), float(flag.sum()), float(_events(flag, prev)),
                (nod * flag[:, None]).sum(0),
                (dwn * flag[:, None]).sum(0).astype(np.float64))

    out = [list(stats(dns_p[y], nodal_p[y], down[y])) for y in range(Y)]
    for j, y in enumerate(pidx):
        if not psel[j]:
            continue
        t = int(T[y])
        pre = stats(dns_p[y, :t], nodal_p[y, :t], down[y, :t])
        prev = bool(t > 0 and dns_p[y, t - 1] > thresh)
        tails = [stats(dns_p[y, t:], nodal_p[y, t:], down[y, t:], prev)]
        for k in range(K - 1):
            tails.append(stats(dns_c[j, k, :H - t], nodal_c[j, k, :H - t],
                               cdown[j, k, :H - t], prev))
        out[y] = [p + sum(tl[i] for tl in tails) / K
                  for i, p in enumerate(pre)]
    return [np.stack([o[i] for o in out]) for i in range(5)]


def _runs(rng, shape, p_toggle=0.08):
    """Flags with long runs (a two-state chain per row)."""
    toggles = rng.random(shape) < p_toggle
    return np.cumsum(toggles, axis=-1) % 2 == 1


@pytest.mark.parametrize("K", [1, 2, 4])
def test_combine_equals_float64_oracle(K):
    rng = np.random.default_rng(100 + K)
    Y, H, nc, nb, S, thresh = 10, 96, 7, 5, 4, 0.01
    f_p = _runs(rng, (Y, H))
    dns_p = np.where(f_p, rng.uniform(1.0, 90.0, (Y, H)),
                     rng.uniform(0.0, 0.02, (Y, H)))     # some <= thresh
    T = np.full(Y, H)
    # Eight parents enter (surplus past S = 4), three of them with the
    # split hour inside a curtailment run (a straddle), one at T = 0.
    for y in range(8):
        inner = np.nonzero(f_p[y, 1:] & f_p[y, :-1])[0] + 1
        T[y] = (inner[len(inner) // 2] if y < 3 and len(inner)
                else (0 if y == 3 else rng.integers(1, H)))
    assert sum(f_p[y, T[y] - 1] & f_p[y, T[y]] for y in range(3)) == 3
    entered = T < H
    order = np.argsort(-(entered * 2 * Y - np.arange(Y)), kind="stable")
    pidx = order[:S]
    psel = entered[pidx]
    f_c = _runs(rng, (S, K - 1, H))
    dns_c = np.where(f_c, rng.uniform(1.0, 90.0, (S, K - 1, H)),
                     rng.uniform(0.0, 0.02, (S, K - 1, H)))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    draw = SplitDraw(
        down=torch.as_tensor(rng.random((Y, nc, H)) < 0.3),
        T=torch.as_tensor(T), entered=torch.as_tensor(entered),
        pidx=torch.as_tensor(pidx), psel=torch.as_tensor(psel),
        clone_down=torch.as_tensor(rng.random((S, K - 1, nc, H)) < 0.3))
    nodal_p = f32(rng.uniform(0, 10, (Y, H, nb)))
    nodal_c = f32(rng.uniform(0, 10, (S, K - 1, H, nb)))
    valid_rel = torch.arange(H)[None, :] < (H - draw.T[draw.pidx])[:, None]
    ens, plc, nlc, dlc, edns, nodal, comp = split_combine(
        draw, f32(dns_p), nodal_p, f32(dns_c), nodal_c, valid_rel, K,
        thresh, H)
    want = _oracle(draw, f32(dns_p), nodal_p, f32(dns_c), nodal_c, K,
                   thresh, H)
    for got, ref, name in zip((ens, dlc, nlc, nodal, comp), want,
                              ("ens", "dlc", "nlc", "nodal", "comp")):
        np.testing.assert_allclose(got.double().numpy(), ref, rtol=2e-6,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(plc.double().numpy(), want[1] / H, rtol=1e-6)
    np.testing.assert_allclose(edns.double().numpy(), want[0] / H,
                               rtol=2e-6)
    # The surplus parents and the never-entered years keep their plain
    # values; a split year differs from its plain value.
    plain = _oracle(draw._replace(psel=torch.zeros_like(draw.psel)),
                    f32(dns_p), nodal_p, f32(dns_c), nodal_c, K, thresh, H)
    keep = np.setdiff1d(np.arange(Y), pidx[psel])
    np.testing.assert_allclose(ens.double().numpy()[keep], plain[0][keep],
                               rtol=2e-6)
    if K > 1:
        assert not np.allclose(ens.double().numpy()[pidx[psel]],
                               plain[0][pidx[psel]])


# --- the port against the reference ---------------------------------------

def test_calibrate_level_matches_reference_quantile():
    # The pilot's quantile at 1,024 years from each package's own stream:
    # each level must lie between the other's quantiles at the target
    # +- 0.05 (the entry fraction's standard error at 1,024 years is
    # 0.0094, so 0.05 is over 5 of them).
    from powersystemsreliabilityassessment_tpu.core import cases as rc
    from powersystemsreliabilityassessment_tpu.core import load_profile as rl
    from powersystemsreliabilityassessment_tpu.core.system import (
        build_system as ref_build)
    from powersystemsreliabilityassessment_tpu.studies import (
        hl2_seq_split as ref_split)
    from powersystemsreliabilityassessment_tpu_torch.core import load_profile
    H = 336
    case = cases.rts24()
    mt = twostate.mean_times(case)
    nd = chronological.default_num_draws(mt[:, 0], mt[:, 1], H)
    sys_ = build_system(case, device=CPU)
    ref_sys = ref_build(rc.rts24())
    fac = load_profile.load_factors(H) * 1.1
    ref_fac = rl.load_factors(H) * 1.1
    np.testing.assert_array_equal(fac, ref_fac)
    port = {p: hl2_seq_split.calibrate_level(sys_, fac, H, nd, p, 1024, 7)
            for p in (0.05, 0.10, 0.15)}
    ref = {p: ref_split.calibrate_level(ref_sys, ref_fac, H, nd, p, 1024, 7)
           for p in (0.05, 0.10, 0.15)}
    assert port[0.05] <= ref[0.10] <= port[0.15], (port, ref)
    assert ref[0.05] <= port[0.10] <= ref[0.15], (port, ref)


def test_split_estimate_matches_reference_run():
    # The same configuration in both packages (hours 504, load 1.2x,
    # level -100 MW, K 4, antithetic clones): EENS, LOLE and LOLF within
    # 4 combined standard errors of the per-year estimates.
    from powersystemsreliabilityassessment_tpu.core import cases as rc
    from powersystemsreliabilityassessment_tpu.studies import (
        hl2_seq_split as ref_split)
    from powersystemsreliabilityassessment_tpu.utils.config import (
        MCSConfig as RefMCS)
    kw = dict(max_lp=64, hours=504, log_every=0, load_scale=1.2)
    sc = dict(level_mw=-100.0, k_clones=4, max_split=4)
    port = run_seq_split_study(
        cases.rts24(), MCSConfig(max_years=48, cov_threshold=0.0, seed=3),
        SplitConfig(**sc), device=CPU, years_per_device=8, **kw)
    ref = ref_split.run_seq_split_study(
        rc.rts24(), RefMCS(max_years=48, cov_threshold=0.0, seed=3),
        ref_split.SplitConfig(**sc), years_per_device=2, **kw)
    assert port.split_entered > 0 and ref.split_entered > 0
    se = lambda v: np.std(v, ddof=1) / np.sqrt(len(v))  # noqa: E731
    ref_years = np.asarray(ref.annual_ens)
    z_eens = abs(port.eens_mwh_yr - ref.eens_mwh_yr) / np.hypot(
        se(port.annual_ens), se(ref_years))
    assert z_eens <= 4.0, (port.eens_mwh_yr, ref.eens_mwh_yr, z_eens)
    # The reference keeps no per-year DLC / NLC: its standard errors are
    # taken as the port's.
    for got, want, years in ((port.lole_hr_yr, ref.lole_hr_yr,
                              port.annual_dlc),
                             (port.lolf_occ_yr, ref.lolf_occ_yr,
                              port.annual_nlc)):
        assert abs(got - want) <= 4.0 * np.sqrt(2.0) * se(years), (got, want)
