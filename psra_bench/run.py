"""Run one cell of the benchmark once and print its result line.

    python -m psra_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start to the window's first dispatch: imports, CUDA,
the kernels' build on a first run, the system, the study's preparation
and the warm batches) is ``setup_s``. The window then runs the study for
``--seconds``. With ``--trace 0`` the result carries the cell's
end-to-end metrics; with ``--trace 1`` a profiler follows a fixed run of
steady steps inside the window and the result carries the per-layer
metrics. Either way the reference then judges what the window produced
(``psra_bench.check``) and ``correct`` says whether every compared number
kept to its limit. The last line of standard output is the result, one
JSON object; the compared numbers and their limits also end standard
error. A card is required: without one, or with fewer than the cell asks
for, the run exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "powersystemsreliabilityassessment_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def process_start() -> float:
    """This process's start on the ``time.time()`` clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_IMPORT


T_IMPORT = time.time()


def load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise BenchError(f"missing {path}") from e


def load_spec(root: Path | None = None) -> dict:
    return load_json((root or Path.cwd()) / "BENCHMARK.json")


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or
    the JAX package's (compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device="cuda", traffic_overrides: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run of ``cell_name``; returns the result object. ``device``
    "cpu" and ``traffic_overrides`` serve the CPU tests."""
    import torch
    from psra_bench import check, trace as tracing

    t_start = process_start() if t_start is None else t_start
    cell = cell_of(spec, cell_name)
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    traffic.update(traffic_overrides or {})
    limits = load_json(HERE / "limits" / f"{cell_name}.json")
    study = importlib.import_module(f"psra_bench.studies.{traffic['study']}")
    driver = study.Driver(cfg, traffic, seed, device)
    driver.warm(int(traffic["warm_batches"]))
    per_layer = [m for m in spec["per_layer"] if applies(m, cell_name)]
    tracer = None
    if trace:
        tracer = tracing.Tracer(per_layer, int(traffic["trace_start"]),
                                int(traffic["trace_steps"]), device)
        tracer.install(driver.loop)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start
    window_s = driver.window(seconds)
    dev = device_info(device)
    units = driver.window_units
    metrics = {}
    breakdown = traced_info = None
    if tracer is not None:
        traced = tracer.finish()
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
        metrics = traced["metrics"]
        breakdown = traced["breakdown"]
        traced_info = {k: traced[k] for k in ("steps", "sync_calls")}
    else:
        values = {study.RATE_METRIC: units / window_s,
                  "peak_mem_gib": dev["memory_peak_bytes"] / 2 ** 30,
                  "setup_s": setup_s}
        for m in spec["end_to_end"]:
            if applies(m, cell_name) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise BenchError(f"modules of JAX or the JAX package loaded: {found}")
    data = driver.check_data()
    del driver, tracer
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.judge(cfg, data, device, dns_limit=limits["dns_gap_mw"])
    t_check = time.perf_counter() - t_check
    correct = check.verdict(numbers, limits)
    compared = {k: {"value": numbers[k], "limit": limits[k]}
                for k in check.NAMES}
    out = {"correct": correct, "attempted": numbers["states_judged"],
           "failed": numbers["states_failed"] + data["overflow"],
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["info"] = {"window_s": window_s, "units": units,
                   "batches": len(data["partials"]),
                   "lp_lanes_judged": numbers["lp_lanes"],
                   "kept_batches": sorted(data["kept"]),
                   "check_s": t_check, "ref_merit": numbers.get("ref_merit"),
                   "spread": numbers.get("spread"), "traced": traced_info}
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="psra_bench", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = process_start()
    try:
        spec = load_spec()
        cell = cell_of(spec, args.workload)
        import torch
        torch.set_num_threads(1)
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < int(cell["chips"]):
            raise BenchError(f"{args.workload} needs {cell['chips']} CUDA "
                             f"device(s); found {have}")
        out = run_cell(spec, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t_start=t_start)
    except BenchError as e:
        print(f"psra_bench: {e}", file=sys.stderr)
        return 2
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
