"""Device time per call of the port's K1 kernel (csrc/ipm_fused.cu),
without the host's cost.

At the lane counts the RTS-24 paths launch (256: the bench step's
max_lp; 2,048: the "lp" study's default_max_lp at batch 8192), on the
real LP lanes chip_smoke.py's k1 phase draws (states with a deficit or
a failed certificate), the kernel is captured 20 times in a CUDA graph
and replayed, so the time per call holds no Python or launch cost
(chip_smoke.py's k1 times go through the wrapper and do). Each shape
also reports the kernel's best_score against the plain version's.

``--warps-per-lane 1`` or ``2`` times that instance of the kernel in
place of the one the wrapper picks (``ops/ipm_fused.py::launch_shape``:
two warps a lane at 256 lanes, one at 2,048). ``--source F.cu``
times another version of ipm_fused.cu (built alone with nvcc into the
package's gitignored ``_build/``) in place of the package's library:
one with the dense-A0 interface of the first port (a0 and mref
pointers, one block a lane) or one with this one's. One version per
process, since versions share kernel names.

Usage (on the card): python3 scripts/torch_k1_bench.py
       [--warps-per-lane 1|2] [--source F.cu]
Prints one line per shape, then one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import _lp_lanes  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.core import cases  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.core.system import (  # noqa: E402
    build_system)
from powersystemsreliabilityassessment_tpu_torch.ops import (  # noqa: E402
    cuda_build as cb, ipm_fused)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (  # noqa: E402
    IPMConfig)

LANES = (256, 2048)
CALLS = 20       # launches per graph
REPLAYS = 5
# The first port's interface: a0 [nb, n] and mref [nl, nb] in place of
# the incidence lists, no launch shape.
_DENSE_ARGS = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 \
    + [ctypes.c_float] * 4 + [ctypes.c_void_p]


def _library(source: str | None):
    """(psra_fused_ipm, dense interface?) of the package or of ``source``."""
    if source is None:
        return cb.library().psra_fused_ipm, False
    src = Path(source).resolve()
    text = src.read_bytes()
    dense = b"const float* a0, const float* mref" in text
    cb.BUILD_DIR.mkdir(exist_ok=True)
    so = cb.BUILD_DIR / f"k1bench_{hashlib.sha256(text).hexdigest()[:16]}.so"
    subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-shared", "-I", str(cb.CSRC),
                    str(src), "-o", str(so)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).psra_fused_ipm
    fn.argtypes = _DENSE_ARGS if dense else cb._SIGNATURES["psra_fused_ipm"]
    fn.restype = ctypes.c_int
    return fn, dense


def _graph_ms(call) -> float:
    """Mean device ms per call of ``call()`` over CALLS calls captured
    once in a CUDA graph and replayed."""
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            call()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (REPLAYS * CALLS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default=None)
    ap.add_argument("--warps-per-lane", type=int, default=None,
                    choices=(1, 2))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_bench: needs a CUDA card")
    fn, dense = _library(args.source)
    sys_ = build_system(cases.rts24(), device="cuda")
    st = ipm_fused.build_structure(sys_)
    cfg = IPMConfig()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for B in LANES:
        lp = _lp_lanes(sys_, B, seed=7)
        c, b = lp[2], lp[3]
        # x, y, zl, zu, best_x, best_score
        res = [torch.empty_like(c), torch.empty_like(b), torch.empty_like(c),
               torch.empty_like(c), torch.empty_like(c),
               torch.empty((B,), device="cuda")]
        ptrs = [t.data_ptr() for t in lp]
        outs = [t.data_ptr() for t in res]
        scal = [float(cfg.tau), float(cfg.regularization), float(cfg.mu_tol),
                float(cfg.center_tol)]
        dims = [B, st.ng, st.nd, st.nl, st.nb, int(cfg.iterations)]
        if dense:
            shape = {}
            call_args = (*ptrs, st.a0_bal.data_ptr(), st.minc_ref.data_ptr(),
                         st.inv_b.data_ptr(), *outs, *dims, *scal)
        else:
            lpb, wpl, smem = ipm_fused.launch_shape(st, B, sms)
            wpl = args.warps_per_lane or wpl
            shape = dict(lanes_per_block=lpb, warps_per_lane=wpl,
                         smem_bytes=smem)
            lists = (st.gen_bus, st.load_bus, st.br_from, st.br_to,
                     st.bus_ptr, st.bus_col)
            call_args = (*ptrs, st.inv_b.data_ptr(),
                         *(t.data_ptr() for t in lists), *outs, *dims, lpb,
                         wpl, smem, *scal)

        def kernel():
            cb.check_launch(fn(*call_args, cb.stream_handle(c)), "k1")

        kernel()
        plain = ipm_fused.fused_ipm_iterations_plain(st, *lp, cfg)
        torch.cuda.synchronize()
        row = dict(best_score_err=float((res[5] - plain[4]).abs().max()),
                   finite=all(bool(torch.isfinite(t).all()) for t in res),
                   ms=_graph_ms(kernel), **shape)
        out[str(B)] = row
        print(f"lanes={B:5d} " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "source": args.source,
                      "lanes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
