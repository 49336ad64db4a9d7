"""The control of the comparison: the reference in the program's place,
computed one precision below the configuration's.

The configurations state float32 with TF32 off, so the control computes
in float32 with every matrix product's operands rounded to TF32
(``reference.lp.Precision("tf32")``): the states of one batch of a cell,
drawn again from the seed, their losses of load, per-bus sheds and
failure flags, the step's sums in that arithmetic, and the fold of as
many such sums as a run folds in float32 (the study folds in float64).
:func:`readings` then judges those answers as ``check.judge`` judges a
run's. A control that the limits do not fail is no control.

    python -m psra_bench.control --workload rts24.nsq.lp --seeds 11,12,13

prints one JSON line a seed (on the card; ``--device cpu`` and
``--batch`` / ``--years`` for a small size on the CPU).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from psra_bench import check, run
from psra_bench.reference import draws
from psra_bench.reference.case import from_config, load_factors
from psra_bench.reference.evaluate import hourly_loads, loss_of_load
from psra_bench.reference.lp import Precision

# Batches folded for the fold's arithmetic: fewer than a run folds, so the
# control's fold error is, if anything, understated.
FOLDED = 100


def _nodal(case, shed, dns, prec):
    """Per-bus sheds (MW) of per-load sheds, the study's noise floors."""
    nodal = torch.zeros((shed.shape[0], case.n_bus), dtype=shed.dtype,
                        device=shed.device)
    nodal.index_add_(1, torch.as_tensor(case.load_bus, device=shed.device),
                     shed)
    thr = float(case.study["nodal_noise_threshold_mw"])
    return torch.where((nodal > thr) & (dns[:, None] > 0), nodal, 0.0)


def control_data(cfg: dict, traffic: dict, seed: int, batch_idx: int,
                 device) -> dict:
    """A driver's ``check_data`` with the control's answers in the
    program's place."""
    case = from_config(cfg)
    prec = Precision("tf32")
    r = prec.round
    lanes = check.lanes_per_solve(case, device)
    f32 = lambda *ts: torch.stack([r(t.to(torch.float32)).sum()  # noqa: E731
                                   for t in ts])
    if traffic["study"] == "seq":
        Y, H = int(traffic["years_per_device"]), int(case.study[
            "hours_per_year_seq"])
        down = draws.seq_states(case, seed, batch_idx, Y, H,
                                draws.num_draws(case, H), device
                                ).reshape(Y * H, -1)
        load = torch.as_tensor(hourly_loads(case, load_factors(case, H)),
                               device=device).repeat(Y, 1)
        dns, shed, _, _ = loss_of_load(case, down, load, prec, lanes)
        nodal = _nodal(case, shed, dns, prec)
        thr = float(case.study["seq_curtail_threshold_mw"])
        d = dns.reshape(Y, H)
        flag = d > thr
        fl = flag.to(torch.float32)
        ens = torch.stack([r(v).sum() for v in d])
        dlc = fl.sum(1)
        fi = flag.to(torch.int64)
        nlc = (((fi[:, 1:] - fi[:, :-1]) == 1).sum(1) + fi[:, 0]).float()
        per_year = torch.stack([ens, dlc / H, nlc, dlc, r(ens / H)])
        nod = r((r(nodal) * fl.reshape(-1)[:, None]).sum(0))
        comp = prec.mm(fl.reshape(1, -1), down.to(torch.float32))[0]
        v = torch.cat([torch.stack([dlc.sum(), dlc.new_zeros(()),
                                    dlc.new_zeros(())]),
                       per_year.reshape(-1), nod, comp]).cpu().numpy()
        P = np.stack([v] * FOLDED).astype(np.float32)
        ens_all = P[:, 3:3 + Y].reshape(-1)
        indices = dict(eens=np.mean(ens_all, dtype=np.float32),
                       lole=np.mean(P[:, 3 + 3 * Y:3 + 4 * Y],
                                    dtype=np.float32),
                       lolf=np.mean(P[:, 3 + 2 * Y:3 + 3 * Y],
                                    dtype=np.float32),
                       nodal_eens=P[:, 3 + 5 * Y:3 + 5 * Y + case.n_bus
                                    ].sum(0, dtype=np.float32)
                       / np.float32(ens_all.size))
        failure = flag.reshape(-1)
        extra = dict(study="seq", years=Y, hours=H)
    else:
        B = int(traffic["batch"])
        down = draws.nsq_states(case, seed, batch_idx, B, device)
        load = torch.as_tensor(case.bus_pd[case.load_bus],
                               device=device)[None, :].expand(B, -1)
        dns, shed, _, _ = loss_of_load(case, down, load, prec, lanes)
        nodal = _nodal(case, shed, dns, prec)
        failure = dns > float(case.study["nsq_fail_flag_threshold_mw"])
        fl = failure.to(torch.float32)
        dns32 = dns.to(torch.float32)
        head = torch.cat([dns32.new_tensor([float(B)]),
                          f32(dns32, r(dns32) * r(dns32), fl, fl),
                          dns32.new_zeros(2)])
        v = torch.cat([head, f32(*nodal.T),
                       prec.mm(fl[None, :], down.to(torch.float32))[0]]
                      ).cpu().numpy()
        P = np.stack([v] * FOLDED).astype(np.float32)
        tot = P.sum(0, dtype=np.float32)
        hours = np.float32(case.study["hours_per_year_annualize"])
        plc = tot[3] / tot[0]
        indices = dict(edns=tot[1] / tot[0], plc=plc, lole=plc * hours,
                       nodal_eens=tot[7:7 + case.n_bus] / tot[0] * hours)
        extra = dict(study="nsq",
                     annualize=float(case.study["hours_per_year_annualize"]))
    kept = {batch_idx: dict(down=down, dns=dns, nodal=nodal,
                            failure=failure, partials=v)}
    return dict(seed=seed, kept=kept, partials=list(P), n_bus=case.n_bus,
                overflow=0, indices=indices, **extra)


def readings(cfg: dict, traffic: dict, seed: int, batch_idx: int,
             device, dns_limit: float) -> dict:
    """The compared numbers of the control on one batch, under the cell's
    ``dns_gap_mw`` limit ``dns_limit``."""
    data = control_data(cfg, traffic, seed, batch_idx, device)
    return check.judge(cfg, data, device, dns_limit)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="psra_bench.control",
                                description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--batch-index", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int)
    p.add_argument("--years", type=int)
    args = p.parse_args(argv)
    spec = run.load_spec()
    cell = run.cell_of(spec, args.workload)
    cfg = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    if args.batch:
        traffic["batch"] = args.batch
    if args.years:
        traffic["years_per_device"] = args.years
    limits = run.load_json(run.HERE / "limits" / f"{args.workload}.json")
    for s in args.seeds.split(","):
        got = readings(cfg, traffic, int(s), args.batch_index, args.device,
                       limits["dns_gap_mw"])
        got["correct"] = check.verdict(got, limits)
        print(json.dumps({"seed": int(s), **{k: got[k] for k in (
            *check.NAMES, "correct", "states_judged", "lp_lanes", "ref_merit",
            "spread")}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
