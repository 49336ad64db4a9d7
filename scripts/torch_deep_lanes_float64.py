#!/usr/bin/env python3
"""Judges K1 and its plain version by the float64 optimum on deep lanes.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_deep_lanes_float64.py [OUT.npz]

Two lane sets where the float32 IPMs part:

* chip_smoke.py enum24's 65,536 real order-5 LP lanes of RTS-24
  (``_enum_lp_lanes``). K1 and its plain version run and are polished on
  the card; of the lanes both keep (quality within the evaluator's 5e-3
  guard on both sides), the counts apart by more than 1e-4, 1e-3, 2.5e-3
  and 5e-3 are printed, and up to 300 lanes apart by more than 1e-3 go
  to float64 HiGHS (``_lp_oracle``): which side is closer, and each
  side's largest distance from the optimum.
* tests/test_torch_gpu.py::test_blackout_batch_on_card_matches_cpu's
  4,096 RTS-24 states (branch unavailability 0.08, numpy seed 21) with
  ``island_blackout``: ``evaluate_states_screened`` on the CPU (the plain
  IPM) and on the card (K1), and for each lane the two put more than
  0.05 MW apart, both answers, their quality, and the float64 optimum of
  the lane's LP after the blackout transform, in MW.

OUT.npz (optional) keeps the enumeration lanes' numbers.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

GUARD = 5e-3


def enumeration_lanes(out_path):
    import numpy as np
    import torch
    import chip_smoke as cs
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines.lp_ipm_structured import (  # noqa: E501
        polish_structured)
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        IPMConfig)
    sys_ = build_system(cases.rts24(), device="cuda")
    args = cs._enum_lp_lanes(sys_, 65536)
    st = ipm_fused.build_structure(sys_)
    cfg = IPMConfig()
    ker = ipm_fused.fused_ipm_iterations(st, *args, cfg)
    pla = ipm_fused.fused_ipm_iterations_plain(st, *args, cfg)
    pk = polish_structured(st, ker, *args, cfg)
    pp = polish_structured(st, pla, *args, cfg)
    q = lambda s: s.primal_residual + 2 * st.n * s.duality_gap
    qk, qp = q(pk), q(pp)
    kept = (qk <= GUARD) & (qp <= GUARD)
    diff = (pk.objective - pp.objective).abs()
    for thr in (1e-4, 1e-3, 2.5e-3, 5e-3):
        print(f"enum kept lanes apart by > {thr}: "
              f"{int((kept & (diff > thr)).sum())}")
    print("enum kept best-score difference max",
          float((ker[4] - pla[4]).abs()[kept].max()))
    lanes = torch.nonzero(kept & (diff > 1e-3)).flatten()
    lanes = lanes[diff[lanes].argsort(descending=True)][:300].tolist()
    opt = cs._lp_oracle(st, args, lanes)
    ek = np.abs(pk.objective[lanes].double().cpu().numpy() - opt)
    ep = np.abs(pp.objective[lanes].double().cpu().numpy() - opt)
    print(f"enum judged lanes {len(lanes)}: kernel closer "
          f"{int((ek < ep).sum())}, plain closer {int((ep < ek).sum())}; "
          f"kernel off max {ek.max():.3e}, plain off max {ep.max():.3e}; "
          f"kernel > guard {int((ek > GUARD).sum())}, plain > guard "
          f"{int((ep > GUARD).sum())}")
    for j, i in enumerate(lanes[:25]):
        print(f"enum lane {i} apart {float(diff[i]):.3e} q_kernel "
              f"{float(qk[i]):.2e} q_plain {float(qp[i]):.2e} kernel "
              f"{float(pk.objective[i]):.5f} plain "
              f"{float(pp.objective[i]):.5f} float64 {opt[j]:.5f}")
    if out_path:
        np.savez(out_path, lanes=np.asarray(lanes), opt=opt, kernel_off=ek,
                 plain_off=ep, diff=diff.cpu().numpy(),
                 q_kernel=qk.cpu().numpy(), q_plain=qp.cpu().numpy())


def blackout_lanes():
    import numpy as np
    import torch
    import chip_smoke as cs
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    rng = np.random.default_rng(21)
    sys_cpu = build_system(cases.rts24(), device="cpu")
    u = sys_cpu.unavail.numpy().astype(np.float64).copy()
    u[sys_cpu.n_gen:] = 0.08
    down = rng.uniform(size=(4096, sys_cpu.n_comp)) < u[None, :]
    down &= ~sys_cpu.always_up_nsq.numpy()[None, :]
    compat = CompatFlags(island_blackout=True)
    outs = {}
    for dev in ("cpu", "cuda"):
        s = build_system(cases.rts24(), device=dev)
        res, _ = dcopf.evaluate_states_screened(
            s, torch.as_tensor(down, device=dev),
            s.load_pd[None, :].expand(4096, s.n_load), 4096, compat,
            IPMConfig(), "lp")
        outs[dev] = (res.dns_mw.cpu().numpy(),
                     res.primal_residual.cpu().numpy())
    far = np.nonzero(np.abs(outs["cpu"][0] - outs["cuda"][0]) > 0.05)[0]
    s = build_system(cases.rts24(), device="cuda")
    d, load, extra = dcopf.apply_island_blackout(
        s, torch.as_tensor(down[far], device="cuda"),
        s.load_pd[None, :].expand(far.size, s.n_load))
    up = 1.0 - d.float()
    br_up = up[:, s.n_gen:].contiguous()
    c, b, l, ub, colscale = dcopf.build_state_lp_vectors(
        s, up[:, :s.n_gen], br_up, load, compat, IPMConfig().theta_max)
    opt = cs._lp_oracle(ipm_fused.build_structure(s),
                        (colscale, br_up, c, b, l, ub), range(far.size))
    for j, i in enumerate(far):
        print(f"blackout lane {i}: cpu {outs['cpu'][0][i]:.4f} MW (q "
              f"{outs['cpu'][1][i]:.2e}), card {outs['cuda'][0][i]:.4f} MW "
              f"(q {outs['cuda'][1][i]:.2e}), islanded "
              f"{float(extra[j].sum()):.4f} MW, float64 "
              f"{opt[j] * s.base_mva:.4f} MW")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.set_num_threads(8)
    enumeration_lanes(sys.argv[1] if len(sys.argv) > 1 else None)
    blackout_lanes()
    return 0


if __name__ == "__main__":
    sys.exit(main())
