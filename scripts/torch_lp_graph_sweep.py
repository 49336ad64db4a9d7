#!/usr/bin/env python3
"""One m <= 72 LP call on the card, eager and as CUDA graphs, by lane
count: the measurement behind ``lp_ipm_structured.GRAPH_MAX_LANES``.

For each lane count, ``dcopf.evaluate_states`` (the build, K1, the
polish, the warm rescue and ``_finalize``) on RTS-24 states drawn with
numpy at three times the outage rates (three branches out on every 32nd
lane), at peak load, runs first on the eager path and then on the graph
path (``GRAPH_MAX_LANES`` set around the call). Each arm reports the
host ms of the call (enqueue only, the device idle at its start), the
wall ms (to a device sync), the device's busy ms and operation count
from one ``torch.profiler`` trace of the call with the runtime call
that launched each operation, ``max_memory_allocated`` and
``max_memory_reserved`` over the arm, and the sum of its DNS (equal on
both paths). Graphs are left out above ``--graph-max``.

    python3 scripts/torch_lp_graph_sweep.py \\
        [--lanes 1024,2048,4096,8192,16384,65536] [--graph-max 16384] \\
        [--reps 20] [--out lp_graph_sweep.json]

Prints one JSON line an arm and writes them all to ``--out``. Needs a
CUDA card.
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from powersystemsreliabilityassessment_tpu_torch.core import cases  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.core.system import (  # noqa: E402
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import (  # noqa: E402
    dcopf, lp_ipm_structured as ls)
from powersystemsreliabilityassessment_tpu_torch.models import twostate  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.runtime import graphs  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def stressed_states(sys_, case, lanes: int, seed: int):
    u = twostate.unavailability(case)
    rng = np.random.default_rng(seed)
    down = rng.uniform(size=(lanes, case.n_comp)) < 3 * u[None, :]
    down[:, 14] = False
    for lane in range(0, lanes, 32):
        down[lane, case.n_gen + rng.choice(case.n_branch, 3,
                                           replace=False)] = True
    return (torch.as_tensor(down, device=sys_.device),
            sys_.load_pd[None].expand(lanes, -1).contiguous())


def device_work(trace_path: str):
    """(device operations, busy ms, operations by launching runtime call)
    of a Chrome trace."""
    with open(trace_path) as f:
        ev = json.load(f)["traceEvents"]
    ops = [e for e in ev if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    runtime = {e["args"].get("correlation"): e["name"] for e in ev
               if e.get("cat") == "cuda_runtime" and e.get("ph") == "X"
               and "args" in e}
    busy, cur = 0.0, None
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in ops):
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    by = {}
    for e in ops:
        name = runtime.get(e.get("args", {}).get("correlation"), "none")
        by[name] = by.get(name, 0) + 1
    return len(ops), busy / 1e3, by


def arm(sys_, down, load, graphed: bool, reps: int, trace_dir: str) -> dict:
    from torch.profiler import ProfilerActivity, profile
    saved = ls.GRAPH_MAX_LANES, ls._chains
    ls.GRAPH_MAX_LANES = down.shape[0] if graphed else 0
    ls._chains = graphs.ChainCache(ls.GRAPH_CHAINS)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):                      # the build, the captures
            dcopf.evaluate_states(sys_, down, load)
        host, wall = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = dcopf.evaluate_states(sys_, down, load)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host.append((t1 - t0) * 1e3)
            wall.append((time.perf_counter() - t0) * 1e3)
        path = f"{trace_dir}/trace.json"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dcopf.evaluate_states(sys_, down, load)
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        n_ops, busy_ms, by = device_work(path)
        return dict(lanes=down.shape[0], path="graph" if graphed else "eager",
                    host_ms=float(np.median(host)),
                    wall_ms=float(np.median(wall)), device_busy_ms=busy_ms,
                    device_ops=n_ops, launched_by=by,
                    max_allocated_mib=torch.cuda.max_memory_allocated() / 2**20,
                    max_reserved_mib=torch.cuda.max_memory_reserved() / 2**20,
                    dns_sum=float(res.dns_mw.double().sum()))
    finally:
        ls.GRAPH_MAX_LANES, ls._chains = saved


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--lanes", default="1024,2048,4096,8192,16384,65536")
    p.add_argument("--graph-max", type=int, default=16384)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", type=Path, default=Path("lp_graph_sweep.json"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.set_num_threads(1)
    case = cases.rts24()
    sys_ = build_system(case, device="cuda")
    rows = []
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for lanes in (int(x) for x in args.lanes.split(",")):
            down, load = stressed_states(sys_, case, lanes, lanes)
            for graphed in (False, True):
                if graphed and lanes > args.graph_max:
                    continue
                row = arm(sys_, down, load, graphed,
                          args.reps if lanes <= 16384 else 4, tmp)
                rows.append(row)
                print(json.dumps(row), flush=True)
    args.out.write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), rows=rows), indent=1))


if __name__ == "__main__":
    main()
