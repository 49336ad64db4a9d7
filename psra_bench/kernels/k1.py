"""K1, the fused interior-point loop of the m <= 72 LP tier
(``ops/ipm_fused.py``, ``csrc/ipm_fused.cu``).

A call runs up to ``iterations`` Mehrotra iterations on B lanes of one
LP (m rows, n columns); a lane whose complementarity falls under the
freeze threshold stops. The work these inputs need is counted per lane
iteration that moved x: at least the m x m Cholesky factor (m^3 / 3)
and two solves (4 m^2). The lanes' iterations are found after the traced
window by running the kernel again on each traced call's own inputs for
1, 2, ... iterations and counting the lanes whose x changed. Bytes: the
lane inputs (colscale, c, l, u: 4n; br_up: nl; b: m; a start point: n)
read once and the outputs (x, zl, zu, best x: 4n; y: m; best score: 1)
written once, float32.
"""
from __future__ import annotations

import dataclasses

import torch

KERNEL_NAMES = ("fused_ipm_kernel",)


def work(lanes: int, m: int, n: int, nl: int, lane_iterations: int,
         warm: bool) -> tuple[float, float]:
    flops = lane_iterations * (m ** 3 / 3 + 4 * m * m)
    n_in = 4 * n + nl + m + (n if warm else 0)
    return flops, 4.0 * lanes * (n_in + 4 * n + m + 1)


def install(tracer):
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_batched)
    table = lp_ipm_batched._DIRECT_KERNELS
    key = "cuda" if torch.device(tracer.device).type == "cuda" else "cpu"
    orig_kernels = table[key]
    orig = orig_kernels.iterate

    def iterate(st, colscale, br_up, c, b, l, u, cfg, x_init=None):
        if tracer.recording:
            tracer.calls["k1"].append(dict(
                fn=orig, st=st, args=(colscale, br_up, c, b, l, u), cfg=cfg,
                x_init=x_init))
        return orig(st, colscale, br_up, c, b, l, u, cfg, x_init=x_init)

    table[key] = orig_kernels._replace(iterate=iterate)
    return [lambda: table.__setitem__(key, orig_kernels)]


def count(calls: list) -> None:
    """Each record's lane iterations, operations and bytes (replaces the
    record's inputs with the counts)."""
    for rec in calls:
        st, args, cfg, x0 = rec["st"], rec["args"], rec["cfg"], rec["x_init"]
        c = args[2]
        prev = torch.full_like(c, float("nan"))
        active = 0
        for k in range(1, cfg.iterations + 1):
            xk = rec["fn"](st, *args, dataclasses.replace(cfg, iterations=k),
                           x_init=x0)[0]
            active += int((xk != prev).any(1).sum())
            prev = xk
        flops, nbytes = work(c.shape[0], st.m, st.n, st.nl, active,
                             x0 is not None)
        rec.clear()
        rec.update(lanes=c.shape[0], lane_iterations=active, flops=flops,
                   bytes=nbytes)
