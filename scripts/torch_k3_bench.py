"""Device time per call of the port's K3 kernels (csrc/blocked_trsm.cu),
without the host's cost.

At the shapes the RTS-96 path launches (2,048 lanes: P 56 forward at
K 56, 23 and 1, backward at K 1; P 23 both ways at K 1), plus backward
at K 56, each kernel and ``torch.linalg.solve_triangular`` are captured
60 times in a CUDA graph and replayed, so the time per call holds no
Python or launch cost (chip_smoke.py's k3 times go through the wrapper
and do). Warm: the same operands every call; cold: rotating over copies
whose pass moves more than 1.25 x the 50 MB L2. L is the Cholesky factor
of a random SPD matrix; ``--sparse`` keeps ~3% of B's entries, as in the
factor's off-diagonal blocks (~97% zeros on RTS-96). ``--source F.cu``
times another version of blocked_trsm.cu (built alone with nvcc into the
package's gitignored ``_build/``) in place of the package's library;
one version per process, since versions share kernel names.

Usage (on the card): python3 scripts/torch_k3_bench.py [--sparse]
       [--source F.cu]
Prints one line per shape, then one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from powersystemsreliabilityassessment_tpu_torch.ops import (  # noqa: E402
    blocked_chol as bl, cuda_build as cb)

LANES = 2048
L2_BYTES = 50e6
PEAK_BYTES_PER_S = 3.35e12
CALLS = 60       # launches per graph
REPLAYS = 5
SHAPES = {"fwd_p56_k56": (True, 56, 56), "bwd_p56_k56": (False, 56, 56),
          "fwd_p56_k23": (True, 56, 23), "fwd_p56_k1": (True, 56, 1),
          "bwd_p56_k1": (False, 56, 1), "fwd_p23_k1": (True, 23, 1),
          "bwd_p23_k1": (False, 23, 1)}


def _library(source: str | None):
    if source is None:
        return cb.library().psra_trsm
    src = Path(source).resolve()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    cb.BUILD_DIR.mkdir(exist_ok=True)
    so = cb.BUILD_DIR / f"k3bench_{digest}.so"
    subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-shared", "-I", str(cb.CSRC),
                    str(src), "-o", str(so)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).psra_trsm
    fn.argtypes = cb._SIGNATURES["psra_trsm"]
    fn.restype = ctypes.c_int
    return fn


def _graph_ms(call, sets) -> float:
    """Mean device ms per call of ``call(*s)`` over CALLS calls cycling
    through ``sets``, captured once in a CUDA graph and replayed."""
    for s in sets:
        call(*s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(CALLS):
            call(*sets[i % len(sets)])
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
    ap.add_argument("--sparse", action="store_true")
    ap.add_argument("--source", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_bench: needs a CUDA card")
    trsm = _library(args.source)
    gen = torch.Generator(device="cuda").manual_seed(0)
    factors = {}
    for P in (56, 23):
        G = torch.randn((LANES, P, P), generator=gen, device="cuda")
        A = G @ G.transpose(1, 2) / P + torch.eye(P, device="cuda")
        factors[P] = torch.linalg.cholesky(A).contiguous()
    lib = torch.linalg.solve_triangular
    out = {}
    for name, (fwd, P, K) in SHAPES.items():
        L = factors[P]
        B = torch.randn((LANES, P, K), generator=gen, device="cuda")
        if args.sparse:
            B = B * (torch.rand(B.shape, generator=gen, device="cuda") < 0.03)
        nbytes = 4 * LANES * (P * (P + 1) // 2 + 2 * P * K)
        n_cold = max(2, math.ceil(1.25 * L2_BYTES / nbytes))
        cold = [(L.clone(), B.clone(), torch.empty_like(B))
                for _ in range(n_cold)]
        X = torch.empty_like(B)

        def kernel(L_, B_, X_):
            err = trsm(L_.data_ptr(), B_.data_ptr(), X_.data_ptr(), LANES, P,
                       K, int(fwd), cb.stream_handle(B_))
            cb.check_launch(err, name)

        kernel(L, B, X)
        plain = (bl.trsm_fwd_plain if fwd else bl.trsm_bwd_plain)(L, B)
        lane = lambda t: t.abs().flatten(1).amax(1)
        row = dict(max_rel_err=float((lane(X - plain)
                                      / lane(plain).clamp_min(1.0)).max()),
                   bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, cold_sets=n_cold,
                   ms=_graph_ms(kernel, [(L, B, X)]),
                   ms_cold=_graph_ms(kernel, cold))
        solve = ((lambda L_, B_, X_: lib(L_, B_, upper=False)) if fwd else
                 (lambda L_, B_, X_: lib(L_.transpose(1, 2), B_, upper=True)))
        row.update(library_ms=_graph_ms(solve, [(L, B, X)]),
                   library_ms_cold=_graph_ms(solve, cold))
        del cold
        out[name] = row
        print(f"{name:12s} " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "sparse": args.sparse, "source": args.source,
                      "shapes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
