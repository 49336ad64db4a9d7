#!/usr/bin/env python3
"""The screened evaluator's tier-1 pass on the card, eager and as one CUDA
graph, by lane count: whether a lane cap on ``dcopf.tier1_chain`` is
needed, and what the graph holds in memory.

For each year count, ``dcopf.certify_states`` runs on an RTS-24 SEQ year
block (``years`` x 8,736 hour-states, sampled as the study samples
them, with its hourly loads and the SEQ step's repair buffer, max(4,096,
lanes / 16)) first on the eager path and then through a fresh graph
chain. Each arm reports the host ms of the call (enqueue only, the
device idle at its start), the wall ms (to a device sync), the device's
busy ms and operation count from one ``torch.profiler`` trace of the
call, ``max_memory_allocated`` over the arm, the memory the chain's
capture reserved (its private pool and the side stream's cuBLAS
workspace), and the number of certified lanes (equal on both paths).

    python3 scripts/torch_tier1_graph_sweep.py [--years 1,4,16,30] \\
        [--reps 20] [--out tier1_graph_sweep.json]

Prints one JSON line an arm and writes them all to ``--out``. Needs a
CUDA card.
"""
import argparse
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from powersystemsreliabilityassessment_tpu_torch.core import (  # noqa: E402
    cases, load_profile)
from powersystemsreliabilityassessment_tpu_torch.core.system import (  # noqa: E402
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.models import twostate  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.runtime import graphs  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.sampling import (  # noqa: E402
    chronological)
from powersystemsreliabilityassessment_tpu_torch.studies import (  # noqa: E402
    hl2_nsq, hl2_seq)

HOURS = 8736


def _lp_sweep():
    spec = importlib.util.spec_from_file_location(
        "torch_lp_graph_sweep", ROOT / "scripts" / "torch_lp_graph_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def year_block(sys_, years: int, seed: int = 2026):
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], HOURS)
    load = hl2_seq.year_block_load(sys_, load_profile.load_factors(HOURS),
                                   years)
    down = hl2_seq.sample_years(hl2_nsq.batch_generator(seed, 0, sys_.device),
                                sys_, years, HOURS, k)
    return down.transpose(1, 2).reshape(years * HOURS, -1), load


def arm(sys_, down, load, graphed: bool, reps: int, trace_dir: str,
        device_work) -> dict:
    from torch.profiler import ProfilerActivity, profile
    lanes = down.shape[0]
    rbuf = max(4096, lanes // 16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    chain = graphs.Chain(down.device, "tier1", sys_) if graphed \
        else graphs.EAGER

    def call():
        return dcopf.certify_states(sys_, down, load, repair_buffer=rbuf,
                                    chain=chain)

    call()                                      # the capture
    torch.cuda.synchronize()
    pool_mib = (torch.cuda.memory_reserved() - reserved0) / 2**20
    host, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cert = call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    path = f"{trace_dir}/trace.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    n_ops, busy_ms, by = device_work(path)
    return dict(lanes=lanes, path="graph" if graphed else "eager",
                host_ms=float(np.median(host)),
                wall_ms=float(np.median(wall)), device_busy_ms=busy_ms,
                device_ops=n_ops, launched_by=by,
                max_allocated_mib=torch.cuda.max_memory_allocated() / 2**20,
                capture_reserved_mib=pool_mib if graphed else None,
                certified=int(cert.certified.sum()))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--years", default="1,4,16,30")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", type=Path, default=Path("tier1_graph_sweep.json"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.set_num_threads(1)
    device_work = _lp_sweep().device_work
    sys_ = build_system(cases.rts24(), device="cuda")
    rows = []
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for years in (int(x) for x in args.years.split(",")):
            down, load = year_block(sys_, years)
            for graphed in (False, True):
                row = arm(sys_, down, load, graphed, args.reps, tmp,
                          device_work)
                rows.append(row)
                print(json.dumps(row), flush=True)
            del down, load
    args.out.write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), rows=rows), indent=1))


if __name__ == "__main__":
    main()
