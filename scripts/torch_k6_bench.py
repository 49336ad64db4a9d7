"""Device time per call of the port's K6 kernel (csrc/hw_sampler.cu),
without the host's cost, and its instructions per Philox call.

At the shape the rng_impl="hw" path draws for the RTS-24 bench batch,
[262144, 71], the kernel is captured 20 times in a CUDA graph and
replayed, so the time per call holds no Python or launch cost. The
states must equal the plain version's bit for bit. The built library's
SASS (``cuobjdump -sass``) gives the instructions of the kernel's loop
over Philox calls and the calls a trip makes (its high-half multiplies
over the 20 of one call), hence the instructions per call beside the
106 32-bit operations the bound counts (chip_smoke.py PHILOX_CALL_OPS).

``--source F.cu`` times another version of hw_sampler.cu, built alone
with nvcc beside its own headers (F.cu's directory), such as the parent
commit's from a ``git archive`` unpacked into the gitignored
``scratch_chip/``. One version per process: compare parent, change,
change, parent in one call.

Usage (on the card): python3 scripts/torch_k6_bench.py [--source F.cu]
Prints one line, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import PHILOX_CALL_OPS, _bound, _philox_ops  # noqa: E402
from torch_k5_bench import build_alone, graph_ms, smi  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.core import cases  # noqa: E402
from powersystemsreliabilityassessment_tpu_torch.core.system import (  # noqa: E402
    build_system)
from powersystemsreliabilityassessment_tpu_torch.ops import (  # noqa: E402
    cuda_build as cb, hw_sampler as hw)
from powersystemsreliabilityassessment_tpu_torch.studies import (  # noqa: E402
    hl2_nsq)

SHAPE = (262144, 71)


def sass_per_call(so: Path, dump: Path | None = None) -> dict:
    """The sampler kernel's loop in the SASS of ``so``: its instructions
    (from the innermost backward branch's target to the branch that
    holds a call's multiplies; the whole kernel where it has no loop),
    the Philox calls a trip makes (high-half multiplies / 20: two a
    round; one without a loop) and their ratio. ``dump``: where to write
    the kernel's SASS (beside the library, in the gitignored build
    directory)."""
    cuobjdump = Path(cb._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    body = sass[sass.index("bernoulli_kernel"):]
    if dump is not None:
        dump.parent.mkdir(exist_ok=True)
        dump.write_text(body)
    addr = [(int(a, 16), op.strip()) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    ops = [(a, op.split()[1] if op.startswith("@") else op.split()[0])
           for a, op in addr]
    wide = lambda lo, hi: sum(1 for a, o in ops if lo <= a <= hi
                              and re.match(r"IMAD\.(HI|WIDE)", o))
    # Backward branches (to an address) are loops; the Philox loop is the
    # innermost one that holds a call's multiplies.
    loops = [(int(m.group(1), 16), a) for a, op in addr
             for m in [re.search(r"BRA\s+0x([0-9a-f]+)", op)]
             if m and int(m.group(1), 16) < a]
    loops = [t for t in loops if wide(*t) >= 10]
    # No loop (one call a thread): the whole kernel.
    lo, hi = min(loops, key=lambda t: t[1] - t[0]) if loops else \
        (addr[0][0], addr[-1][0])
    span = [o for a, o in ops if lo <= a <= hi]
    mulhi = sum(1 for op in span if re.match(r"IMAD\.(HI|WIDE)", op))
    calls = max(round(mulhi / 20), 1) if loops else 1
    counts: dict = {}
    for op in span:
        counts[op] = counts.get(op, 0) + 1
    return dict(loop_instructions=len(span), calls_per_trip=calls,
                instructions_per_call=len(span) / calls,
                top_opcodes=dict(sorted(counts.items(),
                                        key=lambda kv: -kv[1])[:8]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k6_bench: needs a CUDA card")
    source = Path(args.source).resolve() if args.source else \
        cb.CSRC / "hw_sampler.cu"
    print(smi(), flush=True)
    fn, _, _, so = build_alone(source, "psra_bernoulli", "k6bench")
    sys_ = build_system(cases.rts24(), device="cuda")
    B, nc = SHAPE
    thresh = hw.bernoulli_thresholds(sys_.unavail, sys_.always_up_nsq)
    seeds = hw.seed_words(hl2_nsq.batch_generator(0, 0, "cuda"), "cuda")
    out = torch.empty((B, nc), dtype=torch.bool, device="cuda")

    def kernel():
        cb.check_launch(fn(seeds.data_ptr(), thresh.data_ptr(),
                           out.data_ptr(), B, nc, cb.stream_handle(out)),
                        "k6")

    kernel()
    equal = bool(torch.equal(out, hw.sample_states_hw_plain(seeds, thresh,
                                                            B)))
    ms = graph_ms(kernel)
    bound = _bound(_philox_ops(B, nc), B * nc + 4 * nc + 8)
    row = dict(bit_equal=equal, ms=ms, bound_share=bound["bound_ms"] / ms,
               counted_ops_per_call=PHILOX_CALL_OPS, **bound,
               **sass_per_call(so, so.with_suffix(".sass.txt")))
    print(f"k6 shape={B}x{nc} " + " ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "source": os.path.relpath(source, ROOT), **row}))
    if not equal:
        raise SystemExit("torch_k6_bench: states differ from the plain "
                         "version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
