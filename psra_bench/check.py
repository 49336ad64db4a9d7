"""The comparison that decides ``correct``.

After the window the reference judges what the timed path produced, on
the batches the tap kept (a reservoir sample of the window's batches,
drawn from the run's seed) and on every batch's sums:

``states_off``
    component states of the kept batches that differ from the states the
    reference draws again from the seed (exact: limit 0).
``dns_gap_mw``
    the widest gap, over every state of the kept batches, between the
    program's loss of load and the reference's float64 optimum.
``nodal_gap_mw``
    the widest gap between a kept state's per-bus sheds, summed, and the
    reference's loss of load, or by which a bus shed leaves [0, its load].
``flags_off``
    kept states whose failure flag (NSQ: the evaluator's ``failure``;
    SEQ: the curtailment flag of the loss of load) differs from the
    reference's, among those whose reference loss of load lies farther
    than the cell's ``dns_gap_mw`` limit from the flag's threshold
    (exact: limit 0).
``sums_gap_rel``
    the widest relative gap between the sums the step handed the host and
    the float64 sums of the kept states' answers, and between the study's
    indices after the window and the float64 fold of every batch's sums.

Each number is held to its limit in ``limits/<cell>.json``.
"""
from __future__ import annotations

import numpy as np
import torch

from psra_bench.reference import draws
from psra_bench.reference.case import RefCase, from_config, load_factors
from psra_bench.reference.evaluate import hourly_loads, loss_of_load
from psra_bench.reference.lp import Precision

NAMES = ("states_off", "dns_gap_mw", "nodal_gap_mw", "flags_off",
         "sums_gap_rel")


def lanes_per_solve(case: RefCase, device) -> int:
    """LP lanes per solve: about 8 GB of float64 work arrays on the card,
    200 MB on the CPU."""
    m = case.n_bus + case.n_branch
    n = case.n_gen + case.n_load + case.n_branch + case.n_bus
    budget = 8e9 if torch.device(device).type == "cuda" else 2e8
    return max(64, int(budget / (m * n * 8 * 4)))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    if got.size == 0:
        return 0.0
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def _flags_off(flag, dns_ref, thr, dns_limit) -> int:
    """States whose flag differs from ``dns_ref > thr``, leaving out those
    whose reference lies within ``dns_limit`` of ``thr``."""
    clear = (dns_ref - thr).abs() > dns_limit
    return int(((flag.to(torch.bool) != (dns_ref > thr)) & clear).sum())


def _answers(case, down, dns, nodal, dns_ref, bus_load, dns_limit):
    """(dns gap, nodal gap, states past ``dns_limit``) of one kept batch,
    MW."""
    dns = dns.to(torch.float64)
    nodal = nodal.to(torch.float64)
    bad = lambda t: float("inf") if not bool(torch.isfinite(t).all()) \
        else float(t.max()) if t.numel() else 0.0  # noqa: E731
    dns_gap = bad((dns - dns_ref).abs())
    over = torch.maximum((nodal - bus_load).clamp_min(0), (-nodal).clamp_min(0))
    nodal_gap = max(bad((nodal.sum(1) - dns_ref).abs()), bad(over.amax(1)))
    past = int((~((dns - dns_ref).abs() <= dns_limit)).sum())
    return dns_gap, nodal_gap, past, _spread(dns, dns_ref)


def _spread(dns, dns_ref) -> dict:
    """How the gaps of one batch spread: counts past a few sizes (MW) and
    the worst three states (program, reference)."""
    gap = (dns - dns_ref).abs()
    worst = torch.topk(torch.nan_to_num(gap, nan=float("inf")),
                       min(3, gap.numel())).indices
    return {"past_mw": {str(t): int((~(gap <= t)).sum())
                        for t in (0.01, 0.1, 1.0, 10.0)},
            "worst": [[float(dns[i]), float(dns_ref[i])] for i in worst]}


def judge(cfg: dict, data: dict, device, dns_limit: float) -> dict:
    """The compared numbers of a run's ``data`` (a driver's
    ``check_data``) under the cell's ``dns_gap_mw`` limit ``dns_limit``,
    and the count of judged states whose loss of load is more than
    ``dns_limit`` off."""
    case = from_config(cfg)
    prec = Precision("float64")
    lanes = lanes_per_solve(case, device)
    out = dict(states_off=0, dns_gap_mw=0.0, nodal_gap_mw=0.0, flags_off=0,
               sums_gap_rel=0.0, states_judged=0, lp_lanes=0,
               states_failed=0)
    seq = data["study"] == "seq"
    if seq:
        Y, H = data["years"], data["hours"]
        factors = load_factors(case, H)
        load_h = torch.as_tensor(hourly_loads(case, factors), device=device)
        bus_h = torch.as_tensor(np.outer(factors, case.bus_pd), device=device)
        K = draws.num_draws(case, H)
    for idx, k in sorted(data["kept"].items()):
        down = k["down"].to(device)
        if seq:
            ref_down = draws.seq_states(case, data["seed"], idx, Y, H, K,
                                        device).reshape(Y * H, -1)
            load = load_h.repeat(Y, 1)
            bus_load = bus_h.repeat(Y, 1)
        else:
            ref_down = draws.nsq_states(case, data["seed"], idx,
                                        down.shape[0], device)
            load = torch.as_tensor(case.bus_pd[case.load_bus],
                                   device=device)[None, :].expand(
                                       down.shape[0], -1)
            bus_load = torch.as_tensor(case.bus_pd, device=device)[None, :]
        out["states_off"] += int((ref_down != down).sum())
        dns_ref, _, n_lp, merit = loss_of_load(case, ref_down, load, prec,
                                               lanes)
        out["ref_merit"] = max(out.get("ref_merit", 0.0), merit)
        dns_gap, nodal_gap, past, spread = _answers(
            case, down, k["dns"].to(device), k["nodal"].to(device), dns_ref,
            bus_load, dns_limit)
        out["states_failed"] += past
        if seq:
            thr = float(case.study["seq_curtail_threshold_mw"])
            flag = k["dns"].to(device) > thr
        else:
            thr = float(case.study["nsq_fail_flag_threshold_mw"])
            flag = k["failure"].to(device)
        out["flags_off"] += _flags_off(flag, dns_ref, thr, dns_limit)
        agg = out.setdefault("spread", {"past_mw": {}, "worst": []})
        for t, n in spread["past_mw"].items():
            agg["past_mw"][t] = agg["past_mw"].get(t, 0) + n
        agg["worst"] = sorted(agg["worst"] + spread["worst"],
                              key=lambda w: -abs(w[0] - w[1]))[:3]
        out["dns_gap_mw"] = max(out["dns_gap_mw"], dns_gap)
        out["nodal_gap_mw"] = max(out["nodal_gap_mw"], nodal_gap)
        out["states_judged"] += int(down.shape[0])
        out["lp_lanes"] += n_lp
        want = (_seq_sums if seq else _nsq_sums)(case, data, k, down)
        out["sums_gap_rel"] = max(out["sums_gap_rel"],
                                  _rel(_fields(data, k["partials"]), want))
    out["sums_gap_rel"] = max(out["sums_gap_rel"], _fold_gap(data))
    return out


def _fields(data: dict, v) -> np.ndarray:
    """The packed sums a step handed the host, without its overflow and
    infeasibility counts."""
    v = np.asarray(v, np.float64)
    if data["study"] == "seq":
        return v[3:]
    return np.concatenate([v[:5], v[7:]])


def _nsq_sums(case, data, k, down) -> np.ndarray:
    dns = k["dns"].to(torch.float64)
    f = k["failure"].to(torch.float64)
    nodal = k["nodal"].to(torch.float64)
    head = torch.stack([dns.new_tensor(float(dns.shape[0])), dns.sum(),
                        (dns * dns).sum(), f.sum(), f.sum()])
    return torch.cat([head, nodal.sum(0), f @ down.to(torch.float64)]
                     ).cpu().numpy()


def _seq_sums(case, data, k, down) -> np.ndarray:
    Y, H = data["years"], data["hours"]
    thr = float(case.study["seq_curtail_threshold_mw"])
    dns = k["dns"].to(torch.float64).reshape(Y, H)
    flag = dns > thr
    f = flag.to(torch.float64)
    ens = dns.sum(1)
    dlc = f.sum(1)
    fi = flag.to(torch.int64)
    nlc = ((fi[:, 1:] - fi[:, :-1]) == 1).sum(1).to(torch.float64) + fi[:, 0]
    nodal = (k["nodal"].to(torch.float64).reshape(Y, H, -1)
             * f[:, :, None]).sum((0, 1))
    comp = (f.reshape(-1)[:, None] * down.to(torch.float64)).sum(0)
    per_year = torch.stack([ens, dlc / H, nlc, dlc, ens / H]).reshape(-1)
    return torch.cat([per_year, nodal, comp]).cpu().numpy()


def _fold_gap(data: dict) -> float:
    """The study's indices after the window against the float64 fold of
    every folded batch's sums."""
    P = np.stack([np.asarray(v, np.float64) for v in data["partials"]])
    got = data["indices"]
    nb = data["n_bus"]
    if data["study"] == "seq":
        Y = data["years"]
        per_year = P[:, 3:3 + 5 * Y].reshape(len(P), 5, Y)
        ens = per_year[:, 0].reshape(-1)
        want = dict(eens=ens.mean(), lole=per_year[:, 3].mean(),
                    lolf=per_year[:, 2].mean(),
                    nodal_eens=P[:, 3 + 5 * Y:3 + 5 * Y + nb].sum(0)
                    / ens.size)
    else:
        tot = P.sum(0)
        n = tot[0]
        plc = tot[3] / n
        hours = data["annualize"]
        want = dict(edns=tot[1] / n, plc=plc, lole=plc * hours,
                    nodal_eens=tot[7:7 + nb] / n * hours)
    return max(_rel(got[k], want[k]) for k in want)


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in NAMES)
