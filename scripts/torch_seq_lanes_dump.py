#!/usr/bin/env python3
"""Dumps chip_smoke.py seq's 4,096 SEQ LP lanes with K1's results, on the card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_seq_lanes_dump.py OUT.npz

The lanes are the ones phase ``seq`` of chip_smoke.py checks K1 on
(``_seq_lp_lanes`` at seed 11: hour-states of the port's 16-year SEQ
blocks that the certificate leaves uncertified or with a deficit, drawn
on the card's Philox stream, so only the card can draw them). Written to
OUT.npz: the outage states and hourly loads (``down``, ``load``) and
the years drawn for them (``years``); the
polished objective and quality score of K1 and of its plain version on
the card (``kernel_obj``, ``kernel_q``, ``plain_obj``, ``plain_q``);
``evaluate_states`` on the card (``dns``, ``q``, ``cert``); and the K2a
check at the SEQ polish shape with synthetic barrier weights (1e2 / 1e-4
at random, generator seed 1, as chip_smoke.py's polish matrices): per
lane the relative factor differences kernel - plain, kernel - float64
and plain - float64 and the condition number, for A A' (``aat_*``) and
A W^-1 A' + I (``awa_*``), with the weight mask (``wmask``). It prints
the guard counts and the K2a lines. scripts/torch_seq_lane_faults.py
reads the file on the CPU.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N_LANES, SEED = 4096, 11


def _rel(a, b):
    lane = lambda t: t.abs().flatten(1).amax(1)
    return (lane(a.double() - b.double())
            / lane(b.double()).clamp_min(1.0)).cpu().numpy()


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.engines.lp_ipm_structured import (
        polish_structured)
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc, cuda_build, ipm_fused)
    out_path = sys.argv[1]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cuda_build.library()
    sys_ = build_system(cases.rts24(), device="cuda")
    lanes, years, (down, load) = chip_smoke._seq_lp_lanes(sys_, N_LANES,
                                                          SEED)
    colscale, br_up = lanes[0], lanes[1]
    st = ipm_fused.build_structure(sys_)
    out = dict(down=down.cpu().numpy(), load=load.cpu().numpy(),
               years=years)
    for name, fn in (("kernel", ipm_fused.fused_ipm_iterations),
                     ("plain", ipm_fused.fused_ipm_iterations_plain)):
        pol = polish_structured(st, fn(st, *lanes), *lanes)
        out[name + "_obj"] = pol.objective.cpu().numpy()
        out[name + "_q"] = (pol.primal_residual
                            + 2 * st.n * pol.duality_gap).cpu().numpy()
    res = dcopf.evaluate_states(sys_, down, load)
    cert = dcopf.certify_states(sys_, down, load).certified
    out.update(dns=res.dns_mw.cpu().numpy(),
               q=res.primal_residual.cpu().numpy(),
               cert=cert.cpu().numpy())
    print(f"guard failed (polished K1 / plain): "
          f"{int((out['kernel_q'] > 5e-3).sum())} / "
          f"{int((out['plain_q'] > 5e-3).sum())}; evaluate_states: "
          f"{int(((res.primal_residual > 5e-3) & ~cert).sum())} "
          f"uncertified lanes past the guard", flush=True)
    wmask = torch.rand(lanes[2].shape, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda") < 0.5
    w = torch.where(wmask, 1e2, 1e-4)
    m = st.m
    eye = torch.eye(m, device="cuda")
    for tag, wt, add in (("aat", torch.ones_like(w), 0.0),
                         ("awa", 1.0 / w, 1.0)):
        M = ipm_fused.normal_matrix(st, colscale * colscale * wt, br_up)
        M = M + add * eye
        s = torch.rsqrt(torch.diagonal(M, dim1=1, dim2=2).clamp_min(1e-30))
        M = (M * s[:, :, None] * s[:, None, :] + 1e-7 * eye).contiguous()
        Lk, Lp = bc.cholesky(M), bc.cholesky_plain(M)
        L64 = torch.linalg.cholesky_ex(M.double())[0]
        ev = torch.linalg.eigvalsh(M.double())
        out[f"{tag}_kp"], out[f"{tag}_k64"] = _rel(Lk, Lp), _rel(Lk, L64)
        out[f"{tag}_p64"] = _rel(Lp, L64)
        out[f"{tag}_cond"] = (ev[:, -1] / ev[:, 0].clamp_min(1e-300)
                              ).cpu().numpy()
        print(f"K2a {tag}: kernel - plain > 1e-4 on "
              f"{int((out[f'{tag}_kp'] > 1e-4).sum())} lanes; max "
              f"kernel - plain {out[f'{tag}_kp'].max():.3e}, kernel - f64 "
              f"{out[f'{tag}_k64'].max():.3e}, plain - f64 "
              f"{out[f'{tag}_p64'].max():.3e}", flush=True)
    out["wmask"] = wmask.cpu().numpy()
    np.savez_compressed(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
