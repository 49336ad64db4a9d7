"""Device time per call of the port's K5 kernel (csrc/certify_kernel.cu),
without the host's cost.

At the shapes chip_smoke.py's k5 phase checks (262,144 RTS-24 lanes of
plain Monte Carlo states; 8,192 RTS-96 lanes at 10x unavailability,
nominal load, three repair steps), the kernel is captured 20 times in a
CUDA graph and replayed, so the time per call holds no Python or launch
cost (chip_smoke.py's kernel_ms goes through the wrapper and does). Each
shape also reports the kernel's outputs against certify_states(woodbury_k
=2) (differing lanes, deficit error), the launch shape, the lanes queued
for repair, the bound (chip_smoke.py's count for this run's data) and the
share of the bound it reaches, and the times with ``repair_iters`` 0
(the first pass alone: nothing is queued or repaired) and 1.

``--source F.cu`` times another version of certify_kernel.cu, built alone
with nvcc beside its own headers (F.cu's directory) into the package's
gitignored ``_build/``, such as the parent commit's from a ``git
archive`` unpacked into the gitignored ``scratch_chip/``. The earlier
warp-a-lane version is detected from its source and given its own
shared-memory plan (:func:`warp_lane_plan`). Without it, the package's
own source is built the same way. One version per process, since
versions share kernel names: compare parent, change, change, parent in
one call.

``--lanes-per-block N``, ``--split T`` (threads a lane) and ``--stage M``
(the LODF / transfer bits) time the thread-a-lane layout in place of
``launch_shape``'s choices.

Usage (on the card): python3 scripts/torch_k5_bench.py [--source F.cu]
       [--lanes-per-block N] [--split T] [--stage M]
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

from chip_smoke import _bound, _cert_work  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.core import cases  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.core.system import (  # noqa: E402
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.ops import (  # noqa: E402
    certify_kernel as ck, cuda_build as cb)
from powersystemsreliabilityassessment_tpu_torch.sampling.state import (  # noqa: E402
    sample_states)
from powersystemsreliabilityassessment_tpu_torch.studies import (  # noqa: E402
    hl2_nsq)

CALLS = 20       # launches per graph
REPLAYS = 5


def warp_lane_plan(sys_, per_warp_floats: int, mats: int):
    """(stage bits, shared bytes) of the earlier warp-a-lane certificate
    kernels (K5 and K4 before their redesigns): eight warps a block, each
    with ``per_warp_floats`` of scratch, then the matrices of ``mats``
    (PTDF, LODF, transfer, in that order) while the block stays within
    113 KB."""
    warps, budget = 8, 113 * 1024
    nl, nb = sys_.n_branch, sys_.n_bus
    used, stage = 4 * warps * per_warp_floats, 0
    for bit, size in ((ck.STAGE_PTDF, nb * nl), (ck.STAGE_LODF, nl * nl),
                      (ck.STAGE_TRANSFER, nl * nl)):
        if mats & bit and used + 4 * size <= budget:
            stage |= bit
            used += 4 * size
    return stage, used


def warp_lane_scratch(sys_) -> int:
    """Per-warp scratch floats of the warp-a-lane kernels: one unit, one
    load, two bus and two branch vectors."""
    return sys_.n_gen + sys_.n_load + 2 * sys_.n_bus + 2 * sys_.n_branch


def build_alone(source: Path, symbol: str, tag: str):
    """(``symbol`` of ``source`` built alone, the source's text, the
    compiler's resource lines)."""
    text = source.read_bytes()
    cb.BUILD_DIR.mkdir(exist_ok=True)
    so = cb.BUILD_DIR / f"{tag}_{hashlib.sha256(text).hexdigest()[:16]}.so"
    done = subprocess.run(
        [cb._nvcc(), *cb.NVCC_FLAGS, "-shared", "-I", str(source.parent),
         str(source), "-o", str(so)], check=True, capture_output=True,
        text=True)
    fn = getattr(ctypes.CDLL(str(so)), symbol)
    fn.argtypes = cb._SIGNATURES[symbol]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in done.stderr.splitlines()
             if "registers" in ln or "spill" in ln]
    return fn, text, ptxas, so


def graph_ms(call) -> float:
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


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _shapes():
    """(tag, system, states) of chip_smoke.py's k5 timing shapes."""
    sys24 = build_system(cases.rts24(), device="cuda")
    down24 = sample_states(hl2_nsq.batch_generator(0, 11, "cuda"),
                           sys24.unavail, sys24.always_up_nsq, 262144)
    sys96 = build_system(cases.rts96(), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(96)
    u96 = torch.clamp(sys96.unavail * 10.0, max=0.5)
    down96 = (torch.rand((8192, sys96.n_comp), generator=gen,
                         device="cuda") < u96) & ~sys96.always_up_nsq
    return (("rts24_262144", sys24, down24), ("rts96_8192", sys96, down96))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default=None)
    ap.add_argument("--lanes-per-block", type=int, default=None)
    ap.add_argument("--split", type=int, default=None)
    ap.add_argument("--stage", type=int, default=None,
                    help="matrices to stage (STAGE_LODF | STAGE_TRANSFER "
                    "bits) in place of launch_shape's choice")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k5_bench: needs a CUDA card")
    source = Path(args.source).resolve() if args.source else \
        cb.CSRC / "certify_kernel.cu"
    print(smi(), flush=True)
    fn, text, ptxas, _ = build_alone(source, "psra_certify", "k5bench")
    warp_a_lane = b"cert_smem_bytes" not in text
    if warp_a_lane:   # the earlier entry point has no work list
        fn.argtypes = fn.argtypes[:12] + fn.argtypes[13:]
    for ln in ptxas:
        print("ptxas: " + ln, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for tag, sys_, down in _shapes():
        B, ng, nd = down.shape[0], sys_.n_gen, sys_.n_load
        nl, nb = sys_.n_branch, sys_.n_bus
        load = sys_.load_pd[None, :].expand(B, nd).contiguous()
        fbuf, ibuf = ck.kernel_operands(sys_)
        if warp_a_lane:
            stage, smem = warp_lane_plan(sys_, warp_lane_scratch(sys_), 7)
            shape = dict(warps_per_lane=1, stage=stage, smem_bytes=smem)
        else:
            lanes, stage, smem = ck.launch_shape(ng, nd, nl, nb, B, sms,
                                                 args.lanes_per_block,
                                                 args.split)
            if args.stage is not None:
                stage = stage & ~6 | args.stage & 6
                smem = ck.first_pass_smem(ng, nd, nl, nb, lanes, stage)
            shape = dict(lanes_per_block=lanes,
                         threads_per_lane=1 << (stage >> ck.SPLIT_SHIFT & 3),
                         stage=stage & 7, smem_bytes=smem)
        work = torch.empty(B + 1, dtype=torch.int32, device="cuda")
        res = (torch.empty(B, dtype=torch.bool, device="cuda"),
               torch.empty(B, device="cuda"),
               torch.empty((B, nd), device="cuda"),
               torch.empty((B, ng), device="cuda"))

        def kernel(iters=3):
            cb.check_launch(fn(
                down.data_ptr(), load.data_ptr(), fbuf.data_ptr(),
                ibuf.data_ptr(), B, ng, nd, nl, nb, iters, stage, smem,
                *(() if warp_a_lane else (work.data_ptr(),)),
                *(t.data_ptr() for t in res), cb.stream_handle(fbuf)), "k5")

        kernel()
        want = dcopf.certify_states(sys_, down, load, woodbury_k=2)
        n_out = down[:, ng:].sum(1)
        elig = n_out <= 1
        failing = [elig & ~dcopf.certify_states(
            sys_, down, load, repair_iters=k, woodbury_k=2).certified
            for k in range(3)]
        torch.cuda.synchronize()
        bound = _bound(
            _cert_work(sys_, B, int(elig.sum()),
                       repair_steps=sum(int(f.sum()) for f in failing),
                       single=int((n_out == 1).sum()),
                       pairs=int((n_out == 2).sum())),
            B * (sys_.n_comp + 4 * nd + 1 + 4 + 4 * nd + 4 * ng)
            + 4 * fbuf.numel() + 4 * ibuf.numel())
        lanes_differing = int((res[0] != want.certified).sum())
        deficit_err = float((res[1] - want.deficit).abs().max())
        ms = graph_ms(kernel)
        # No repair step (nothing queued): the first pass alone; and one.
        first_ms = graph_ms(lambda: kernel(0))
        one_step_ms = graph_ms(lambda: kernel(1))
        row = dict(lanes_differing=lanes_differing, deficit_err=deficit_err,
                   queued=int(failing[0].sum()), ms=ms,
                   first_pass_ms=first_ms, one_step_ms=one_step_ms,
                   bound_share=bound["bound_ms"] / ms, **bound, **shape)
        out[tag] = row
        print(f"{tag} " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "source": os.path.relpath(source, ROOT),
                      "shapes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
