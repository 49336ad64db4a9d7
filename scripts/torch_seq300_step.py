#!/usr/bin/env python3
"""The case300s SEQ step at several LP buffers, on the card (the port's
counterpart of scripts/probe_seq300_step.py).

Runs the first case300s year block of seed 0 through
``hl2_seq.make_seq_batch_step`` at two years a step with 64, 128, 256,
512, 1,024 and 2,048 LP lanes a year, and at four years a step with
1,024, and prints one line per arm: the block's overflow hours, the
step's wall ms (synchronized), device ms and kernel launches
(torch.profiler), host reads (set_sync_debug_mode("warn")),
``torch.cuda.max_memory_allocated``, tier 1's misses and LP queue, the
share of that queue tier 1.5 certified, the LP lanes and the LP lanes
past the 5e-3 guard. The card's name and power limit come first; with
``--out FILE`` the rows are also written there as JSON.

    python3 scripts/torch_seq300_step.py [--out seq300_step.json]
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ARMS = ((2, 64), (2, 128), (2, 256), (2, 512), (2, 1024), (2, 2048),
        (4, 1024))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the rows here (JSON)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_seq300_step: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from powersystemsreliabilityassessment_tpu_torch.core import (
        cases, load_profile)
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    case = cases.case300s()
    sys_ = build_system(case, device="cuda")
    factors = load_profile.load_factors(8736)
    rows = []
    for years, max_lp in ARMS:
        probe = cs._SeqProbe()
        row = cs._seq_step_costs("seq300_step", case, sys_, years, max_lp,
                                 factors, seed=0, probe=probe)
        blk = probe.rows()[0]
        row.update({k: blk[k] for k in (
            "tier1_misses", "tier1_queue", "tier15_certified_share",
            "lp_queue", "lp_lanes", "past_guard")}, card=smi)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
