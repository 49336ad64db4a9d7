"""BENCHMARK.json against the contract's shape, the layer map, the
kernel counts, and the imports of the harness."""
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    assert all(m["bound"] <= 0.25 for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_and_metrics(cell):
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    assert w["chips"] == 1
    assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    assert (HERE / "limits" / f"{cell}.json").exists()
    applies = lambda m: cell in m.get("workloads", [cell])  # noqa: E731
    e2e = [m["name"] for m in SPEC["end_to_end"] if applies(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in SPEC["per_layer"] if applies(m)]
    assert per
    for m in per:
        assert m["moves"] in e2e
        importlib.import_module(
            "psra_bench.metrics." + m["name"].split(".")[0])


def test_config_files():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_layer_map_names_functions_that_exist():
    layers = json.loads((HERE / "layers.json").read_text())
    for paths in layers.values():
        for path in paths:
            mod, attr = path.split(":")
            assert callable(getattr(importlib.import_module(mod), attr)), path


def test_kernel_counts_match_the_kernel_table():
    import chip_smoke
    from psra_bench.kernels import k1, peaks
    # K1 at the table's shapes (RTS-24: m 62, n 112, nl 38): 256 and
    # 2,048 lanes from the box midpoint, 16 from a start point.
    m, n, nl = 62, 112, 38
    for lanes, active, warm in ((256, 256 * 16, False),
                                (2048, 2048 * 11, False), (16, 40, True)):
        n_in = 4 * n + nl + m + (n if warm else 0)
        want = chip_smoke._bound(active * (m ** 3 / 3 + 4 * m * m),
                                 4 * lanes * (n_in + (4 * n + m + 1)))
        got = peaks.bound_s(*k1.work(lanes, m, n, nl, active, warm))
        assert got * 1e3 == pytest.approx(want["bound_ms"])


def test_harness_imports_nothing_of_jax():
    mods = sorted("psra_bench." + ".".join(p.relative_to(HERE).with_suffix(
        "").parts) for p in HERE.rglob("*.py")
        if "tests" not in p.relative_to(HERE).parts
        and p.name != "__init__.py"
        and p.name != "__main__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', "
            "'powersystemsreliabilityassessment_tpu'})\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_reference_imports_nothing_of_the_program():
    for p in (HERE / "reference").glob("*.py"):
        text = p.read_text()
        assert "powersystemsreliabilityassessment_tpu" not in text, p
        assert "import jax" not in text, p
