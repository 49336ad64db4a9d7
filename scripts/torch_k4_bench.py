"""Device time per call of the port's K4 kernel (csrc/fused_sampler_cert.cu),
without the host's cost.

At the lane counts the fused RTS-24 paths launch (262,144: the fused
bench step's batch; 8,192: the fused study's MCSConfig.batch_size), in
random-state mode under the calibrated shed hint, the kernel is captured
20 times in a CUDA graph and replayed, so the time per call holds no
Python or launch cost (chip_smoke.py's k4 times go through the wrapper
and do). Each shape also reports the kernel's outputs against the plain
version's (states bit for bit, deficit and shed, first-pass agreement),
its launch shape, its bound (chip_smoke.py's count for this run's data)
and the share of the bound it reaches.

``--source F.cu`` times another version of fused_sampler_cert.cu, built
alone with nvcc beside its own headers (F.cu's directory) into the
package's gitignored ``_build/``, such as the parent commit's from a
``git archive`` unpacked into the gitignored ``scratch_chip/``. The
earlier warp-a-lane version is detected from its source and given its
shared-memory plan (``torch_k5_bench.warp_lane_plan``). Without it, the package's own source is built the same
way. One version per process, since versions share kernel names.
``--lanes-per-block N`` and ``--split T`` (threads a lane: 1, 2, 4 or 8)
time the thread-a-lane layout with N lanes a block and T threads a lane
in place of ``launch_shape``'s choices.

Usage (on the card): python3 scripts/torch_k4_bench.py [--source F.cu]
       [--lanes-per-block N] [--split T]
Prints the compiler's resource line, one line per shape, then one JSON
line.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    K4_LANES, _bound, _cert_work, _philox_ops)
from torch_k5_bench import warp_lane_plan, warp_lane_scratch  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.core import cases  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.core.system import (  # noqa: E402
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.ops import (  # noqa: E402
    certify_kernel as ck, cuda_build as cb, fused_sampler_cert as ff,
    hw_sampler as hw)
from powersystemsreliabilityassessment_tpu_torch.studies import (  # noqa: E402
    hl2_nsq)

CALLS = 20       # launches per graph
REPLAYS = 5


def _library(source: Path):
    """(psra_fused_sampler_cert of ``source`` built alone, warp-a-lane
    layout?, the compiler's resource lines)."""
    text = source.read_bytes()
    cb.BUILD_DIR.mkdir(exist_ok=True)
    so = cb.BUILD_DIR / f"k4bench_{hashlib.sha256(text).hexdigest()[:16]}.so"
    done = subprocess.run(
        [cb._nvcc(), *cb.NVCC_FLAGS, "-shared", "-I", str(source.parent),
         str(source), "-o", str(so)], check=True, capture_output=True,
        text=True)
    fn = ctypes.CDLL(str(so)).psra_fused_sampler_cert
    fn.argtypes = cb._SIGNATURES["psra_fused_sampler_cert"]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in done.stderr.splitlines()
             if "registers" in ln or "spill" in ln]
    return fn, b"quick_lane_bytes" not in text, ptxas


def _graph_ms(call) -> float:
    """Mean device ms per call of ``call()`` over CALLS calls captured
    once in a CUDA graph and replayed."""
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # Relaxed: the warp-a-lane version's launcher sets the kernel's
    # attributes on every call, which a global-mode capture may refuse.
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
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
    ap.add_argument("--lanes-per-block", type=int, default=None)
    ap.add_argument("--split", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k4_bench: needs a CUDA card")
    source = Path(args.source).resolve() if args.source else \
        cb.CSRC / "fused_sampler_cert.cu"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    fn, warp_a_lane, ptxas = _library(source)
    for ln in ptxas:
        print("ptxas: " + ln, flush=True)
    sys_ = build_system(cases.rts24(), device="cuda")
    ng, nd, nl, nb, nc = (sys_.n_gen, sys_.n_load, sys_.n_branch,
                          sys_.n_bus, sys_.n_comp)
    hint = torch.as_tensor(dcopf.calibrate_shed_hint(sys_), device="cuda")
    fbuf, ibuf, thresh = ff.kernel_operands(sys_, hint)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    eps = ff.guard_eps(sys_)
    out = {}
    for B in K4_LANES:
        if warp_a_lane:
            stage, smem = warp_lane_plan(
                sys_, warp_lane_scratch(sys_) + (nc + 3) // 4,
                ck.STAGE_PTDF | ck.STAGE_LODF)
            shape = dict(warps_per_lane=1, stage=stage, smem_bytes=smem)
        else:
            lanes, stage, smem = ff.launch_shape(ng, nd, nl, nb, B, sms,
                                                 args.lanes_per_block,
                                                 args.split)
            shape = dict(lanes_per_block=lanes,
                         threads_per_lane=1 << (stage >> ff.SPLIT_SHIFT),
                         stage=stage & 7, smem_bytes=smem)
        seeds = hw.seed_words(hl2_nsq.batch_generator(0, 7, "cuda"), "cuda")
        res = (torch.empty((B, nc), dtype=torch.bool, device="cuda"),
               torch.empty(B, dtype=torch.bool, device="cuda"),
               torch.empty(B, device="cuda"),
               torch.empty((B, nd), device="cuda"))

        def kernel():
            cb.check_launch(fn(
                seeds.data_ptr(), thresh.data_ptr(), None, fbuf.data_ptr(),
                ibuf.data_ptr(), B, ng, nd, nl, nb, stage, smem, eps,
                *(t.data_ptr() for t in res), cb.stream_handle(fbuf)), "k4")

        kernel()
        down, ok1, deficit, shed = ff.sample_certify_quick_plain(
            sys_, B, seeds, thresh, hint=hint)
        torch.cuda.synchronize()
        n_out = down[:, ng:].sum(1)
        n_elig = int((n_out <= 1).sum())
        bound = _bound(_cert_work(sys_, B, n_elig, flow_lanes=n_elig,
                                  single=int((n_out == 1).sum()))
                       + _philox_ops(B, nc),
                       B * nc + B * (1 + 4 + 4 * nd) + 4 * fbuf.numel()
                       + 4 * ibuf.numel() + 4 * nc + 8)
        ms = _graph_ms(kernel)
        row = dict(states_equal=bool(torch.equal(res[0], down)),
                   first_pass_agree=float((res[1] == ok1).float().mean()),
                   deficit_err=float((res[2] - deficit).abs().max()),
                   shed_err=float((res[3] - shed).abs().max()),
                   ms=ms, bound_share=bound["bound_ms"] / ms, **bound,
                   **shape)
        out[str(B)] = row
        print(f"lanes={B:6d} " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "source": os.path.relpath(source, ROOT),
                      "lanes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
