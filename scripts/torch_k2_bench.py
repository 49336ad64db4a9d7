"""Device time per call of the port's K2 kernels (csrc/batched_chol.cu),
without the host's cost.

At the four shapes the main paths launch, on the paths' own matrices
(chip_smoke.py's builders): K2a at the RTS-24 polish's [256, 62, 62]
and RTS-96's diagonal panels [2048, 56, 56] and [2048, 23, 23], K2b at
the polish's [256, 62]. Each kernel and one library call
(``torch.linalg.cholesky_ex`` / ``torch.cholesky_solve``) are captured
20 times in a CUDA graph and replayed 5 times, so the time per call
holds no Python or launch cost (chip_smoke.py's k2 phase reports both);
warm (the same operands every call) and cold (rotating over copies
whose pass moves more than 1.25 x the 50 MB L2). Each shape also
reports the kernel's distance from its plain version, its bound and
the share of it each time reaches.

``--source F.cu`` times another version of batched_chol.cu, built alone
with nvcc beside its own headers (F.cu's directory) into the package's
gitignored ``_build/``, such as the parent commit's from a ``git
archive`` unpacked into the gitignored ``scratch_chip/``; the first
port's interface (a block a system, no launch shape) is detected from
the source. Without it, the package's own source is built the same way. One
version per process, since versions share kernel names.
``--warps-per-lane N`` (1, 2 or 4) sets K2a's warps a system in place
of ``launch_shape``'s choice.

Usage (on the card): python3 scripts/torch_k2_bench.py [--source F.cu]
       [--warps-per-lane N]
Prints the card, the compiler's resource lines, one line per shape, then
one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    L2_BYTES, _bound, _graph_ms, _k2_fns, _k2_inputs, _k2_work,
    _plain_blocked_kernels, _rel_err)
from powersystemsreliabilityassessment_tpu_torch.core import cases  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.core.system import (  # noqa: E402
    build_system)
from powersystemsreliabilityassessment_tpu_torch.ops import (  # noqa: E402
    batched_chol as bc, cuda_build as cb)


def _library(source: Path):
    """(the built library, the first port's interface?, the compiler's
    resource lines) of ``source`` built alone."""
    text = source.read_bytes()
    cb.BUILD_DIR.mkdir(exist_ok=True)
    so = cb.BUILD_DIR / f"k2bench_{hashlib.sha256(text).hexdigest()[:16]}.so"
    done = subprocess.run(
        [cb._nvcc(), *cb.NVCC_FLAGS, "-shared", "-I", str(source.parent),
         str(source), "-o", str(so)], check=True, capture_output=True,
        text=True)
    lib = ctypes.CDLL(str(so))
    first = b"warps_per_lane" not in text
    lib.psra_cholesky.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        if first else cb._SIGNATURES["psra_cholesky"])
    lib.psra_cho_solve.argtypes = cb._SIGNATURES["psra_cho_solve"]
    lib.psra_cholesky.restype = lib.psra_cho_solve.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in done.stderr.splitlines()
             if "registers" in ln or "spill" in ln]
    return lib, first, ptxas


def _library_ms(fn, sets, graph: bool) -> tuple:
    """(ms, timer) of the library call: in a CUDA graph where the call
    can be captured (``cholesky_ex``), else CUDA events around 20 calls
    cycling through ``sets`` (``cholesky_solve``, whose MAGMA kernel
    refuses capture; its calls are long enough that the host keeps
    ahead)."""
    if graph:
        return _graph_ms(fn, sets), "graph"
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for i in range(20):
        fn(*sets[i % len(sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 20, "events"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default=None)
    ap.add_argument("--warps-per-lane", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_bench: needs a CUDA card")
    source = Path(args.source).resolve() if args.source else \
        cb.CSRC / "batched_chol.cu"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib, first, ptxas = _library(source)
    for ln in ptxas:
        print("ptxas: " + ln, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # The inputs come from the plain versions of K2 and K3 (the blocked
    # route builds the panels): a second library with the same kernel
    # names would make this process's launches fail.
    with _plain_blocked_kernels():
        shapes = _k2_inputs(build_system(cases.rts24(), device="cuda"),
                            build_system(cases.rts96(), device="cuda"))
    out = {}
    for name, (kind, ops) in shapes.items():
        _, plain, library = _k2_fns(kind)
        B, m = ops[-1].shape[:2]
        if kind == "cholesky":
            shape = (None if first else
                     bc.launch_shape(B, m, sms, args.warps_per_lane))

            def kernel(M_, L_):
                extra = () if shape is None else shape
                cb.check_launch(lib.psra_cholesky(
                    M_.data_ptr(), L_.data_ptr(), B, m, *extra,
                    cb.stream_handle(M_)), name)

            sets = [(ops[0], torch.empty_like(ops[0]))]
        else:
            shape = None

            def kernel(L_, r_, x_):
                cb.check_launch(lib.psra_cho_solve(
                    L_.data_ptr(), r_.data_ptr(), x_.data_ptr(), B, m,
                    cb.stream_handle(r_)), name)

            sets = [(*ops, torch.empty_like(ops[1]))]
        kernel(*sets[0])
        want = plain(*ops)
        torch.cuda.synchronize()
        flops, nbytes = _k2_work(kind, ops)
        n_cold = max(2, math.ceil(1.25 * L2_BYTES / nbytes))
        cold = [tuple(t.clone() for t in sets[0]) for _ in range(n_cold)]
        lib_call = lambda *s: library(*s[:len(ops)])
        bound = _bound(flops, nbytes)
        row = dict(max_rel_err=_rel_err(sets[0][-1], want), **bound,
                   cold_sets=n_cold, ms=_graph_ms(kernel, sets),
                   ms_cold=_graph_ms(kernel, cold))
        graph = kind == "cholesky"
        row["library_ms"], row["library_timer"] = _library_ms(lib_call, sets,
                                                              graph)
        row["library_ms_cold"], _ = _library_ms(lib_call, cold, graph)
        row.update(bound_share=row["bound_ms"] / row["ms"],
                   bound_share_cold=row["bound_ms"] / row["ms_cold"])
        if shape is not None:
            row.update(warps_per_lane=shape[0], lanes_per_block=shape[1],
                       smem_bytes=shape[2])
        del cold
        out[name] = row
        print(f"{name:12s} " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "source": os.path.relpath(source, ROOT),
                      "first_interface": first, "shapes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
