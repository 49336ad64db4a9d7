"""The port's command line (``python -m
powersystemsreliabilityassessment_tpu_torch``), its profiling hooks and
its lazy top-level API.

Every parse case of tests/test_cli.py against the port's parser, the
three ``seq`` conflicts through a subprocess, each subparser's flags
against the reference's, and the studies dispatched on the CPU at tiny
sizes with their exports, JSON lines and figures (and the stderr line in
their place when matplotlib cannot be imported).
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from powersystemsreliabilityassessment_tpu.__main__ import (
    build_parser as ref_build_parser)
from powersystemsreliabilityassessment_tpu_torch.__main__ import (
    build_parser, main)

ROOT = Path(__file__).resolve().parents[1]
PKG = "powersystemsreliabilityassessment_tpu_torch"
CPU = ["--device", "cpu"]


@pytest.mark.parametrize("argv", [
    ["nsq"],
    ["nsq", "--samples", "1000", "--batch", "512", "--beta", "0.01",
     "--seed", "3", "--is-boost", "2.5", "--control-variate",
     "--checkpoint", "/tmp/x.json", "--checkpoint-backend", "orbax"],
    ["nsq", "--case", "path/to/case.m"],
    ["nsq", "--early-exit"],
    ["nsq", "--is-boost", "8", "--is-boost-scope", "gens"],
    ["nsq", "--is-boost", "8", "--is-boost-scope", "branches"],
    ["seq", "--early-exit", "--control-variate"],
    ["seq"],
    ["seq", "--years", "100", "--cov", "0.1", "--years-per-device", "8",
     "--sampling", "stationary", "--control-variate"],
    ["seq", "--split-level", "auto", "--split-k", "6", "--split-max", "4"],
    ["seq", "--split-level", "-150.0"],
    ["seq", "--maintenance"],
    ["hl1", "--iterations", "100", "--years", "10"],
    ["education", "--out", "results"],
    ["planning", "--mc-years", "50", "--hydro-hours", "50"],
    ["multiarea", "--system", "demo"],
    ["multiarea", "--system", "ring", "--areas", "5"],
    ["multiarea", "--system", "case", "--case", "rts96"],
    ["scaleup", "--case", "case300s", "--samples", "1000"],
    ["bench"],
])
def test_documented_combinations_parse(argv):
    args = build_parser().parse_args(argv)
    assert args.study == argv[0]
    assert vars(args) == {**vars(ref_build_parser().parse_args(argv)),
                          **({"device": "cuda"} if argv[0] != "bench"
                             else {})}


@pytest.mark.parametrize("argv", [
    ["seq", "--sampling", "bogus"],
    ["multiarea", "--system", "bogus"],
    ["nsq", "--checkpoint-backend", "bogus"],
    ["nsq", "--is-boost-scope", "bogus"],
    [],
])
def test_invalid_flags_rejected(argv):
    with pytest.raises(SystemExit):
        build_parser().parse_args(argv)


@pytest.mark.parametrize("argv,needle", [
    (["seq", "--split-level", "auto", "--control-variate"],
     "--control-variate"),
    (["seq", "--split-level", "auto", "--sampling", "stationary"],
     "--control-variate"),
    (["seq", "--split-level", "auto", "--maintenance"], "--maintenance"),
])
def test_conflicting_combinations_error(argv, needle):
    r = subprocess.run([sys.executable, "-m", PKG, *argv],
                       capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 2
    assert needle in r.stderr


def _subparsers(parser):
    return next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction)).choices


def _options(sub):
    return {tuple(a.option_strings): (a.dest, a.default, a.choices, a.type,
                                      a.nargs, a.const, type(a).__name__)
            for a in sub._actions if "--device" not in a.option_strings}


@pytest.mark.parametrize("study", ["nsq", "seq", "hl1", "education",
                                   "planning", "multiarea", "scaleup",
                                   "bench"])
def test_subparser_flags_equal_reference(study):
    ours, ref = _subparsers(build_parser()), _subparsers(ref_build_parser())
    assert set(ours) == set(ref)
    assert _options(ours[study]) == _options(ref[study])
    device = [a for a in ours[study]._actions
              if "--device" in a.option_strings]
    assert [a.default for a in device] == ([] if study == "bench"
                                           else ["cuda"])


def _json_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_nsq_exports_json_and_figures(tmp_path, capsys):
    out = tmp_path / "nsq"
    main(["nsq", "--samples", "4096", "--batch", "2048", "--seed", "5",
          "--out", str(out), *CPU])
    line = _json_line(capsys.readouterr().out)
    assert set(line) == {"edns", "lole", "plc", "beta"}
    data = json.loads((out / "nsq_results.json").read_text())
    assert data["samples"] == 4096
    assert line["edns"] == data["edns_mw"] and line["beta"] == data["beta"]
    for name in ("nsq_nodal_results.csv", "nsq_reliability_results.mat",
                 "convergence.png", "nodal_reliability.png"):
        assert (out / name).stat().st_size > 0, name


def test_nsq_case_file_gives_the_same_json(tmp_path, capsys):
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.matpower_io import (
        save_matpower_case)
    path = tmp_path / "rts24.m"
    save_matpower_case(cases.rts24(), str(path))
    lines = []
    for case in ("rts24", str(path)):
        main(["nsq", "--samples", "2048", "--batch", "2048", "--seed", "5",
              "--case", case, "--out", str(tmp_path / "o"), *CPU])
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert lines[0] == lines[1]


def test_scaleup_json(capsys):
    main(["scaleup", "--case", "rts24", "--samples", "4096", *CPU])
    line = _json_line(capsys.readouterr().out)
    assert line["case"] == "rts24" and line["n_comp"] == 71
    assert line["samples"] == 4096 and line["antithetic"] is True
    assert line["edns_mw"] > 0 and line["beta"] > 0


def test_education_figures(tmp_path, capsys):
    out = tmp_path / "edu"
    main(["education", "--out", str(out), *CPU])
    line = _json_line(capsys.readouterr().out)
    assert line == {"figures": ["markov_process.png",
                                "parameter_estimation.png",
                                "copt_adequacy.png"], "out": str(out)}
    for name in line["figures"]:
        assert (out / name).stat().st_size > 0, name


def test_planning_json_and_tail_risk_figure(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)          # the figure goes to results/
    main(["planning", "--mc-years", "20", "--hydro-hours", "50", *CPU])
    line = _json_line(capsys.readouterr().out)
    assert set(line) == {"analytical_lole", "mc_lole", "diff_percent",
                         "success", "var95", "cvar95"}
    assert line["analytical_lole"] > 0
    assert (tmp_path / "results" / "tail_risk.png").stat().st_size > 0


def test_multiarea_demo_table(capsys):
    main(["multiarea", "--system", "demo", "--years", "2", *CPU])
    text = capsys.readouterr().out
    assert "MULTI-AREA COMPARISON" in text
    assert "Area_Rich" in text and "Area_Poor" in text


def test_hl1_writes_its_figure(tmp_path, capsys):
    main(["hl1", "--iterations", "2000", "--years", "4", "--out",
          str(tmp_path), *CPU])
    assert "METHOD COMPARISON SUMMARY" in capsys.readouterr().out
    assert (tmp_path / "hl1_comparison.png").stat().st_size > 0


def test_without_matplotlib_exports_and_one_stderr_line(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    out = tmp_path / "nsq"
    main(["nsq", "--samples", "2048", "--batch", "2048", "--out", str(out),
          *CPU])
    captured = capsys.readouterr()
    assert set(_json_line(captured.out)) == {"edns", "lole", "plc", "beta"}
    assert sorted(os.listdir(out)) == [
        "nsq_nodal_results.csv", "nsq_reliability_results.mat",
        "nsq_results.json"]
    lines = [ln for ln in captured.err.splitlines() if "matplotlib" in ln]
    assert lines == [f"matplotlib is not installed; figures not written: "
                     f"{out}/convergence.png, {out}/nodal_reliability.png"]
    main(["hl1", "--iterations", "1000", "--years", "2", "--out",
          str(tmp_path / "hl1"), *CPU])
    err = capsys.readouterr().err
    assert "figures not written: " + str(tmp_path / "hl1") in err
    assert not (tmp_path / "hl1" / "hl1_comparison.png").exists()


@pytest.mark.parametrize("argv,needle", [
    (["nsq", "--checkpoint-backend", "orbax", *CPU], "JSON checkpoints"),
    (["seq", "--checkpoint-backend", "orbax", *CPU], "JSON checkpoints"),
    (["bench"], "Queue 1 item 1"),
])
def test_orbax_and_bench_exit_2(argv, needle, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    assert needle in capsys.readouterr().err


# --- utils/profiling.py ---------------------------------------------------

def test_timings_report_equals_reference(monkeypatch):
    from powersystemsreliabilityassessment_tpu.utils import (
        profiling as ref_prof)
    from powersystemsreliabilityassessment_tpu_torch.utils import profiling
    reports = []
    for mod in (profiling, ref_prof):
        ticks = iter([0.0, 1.25, 2.0, 2.5, 3.0, 7.5, 10.0, 10.001])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        t = mod.Timings()
        with t.section("sample", items=4096):
            pass
        with t.section("evaluate"):
            pass
        with t.section("sample", items=4096):
            pass
        with t.section("fold", items=10):
            pass
        reports.append(t.report())
    assert reports[0] == reports[1]
    assert reports[0].splitlines()[1].startswith("sample")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch
    from powersystemsreliabilityassessment_tpu_torch.utils import profiling
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert data["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())


# --- the lazy top-level API -----------------------------------------------

def test_lazy_api_lists_and_resolves_the_reference_names():
    import importlib
    import powersystemsreliabilityassessment_tpu as ref
    import powersystemsreliabilityassessment_tpu_torch as port
    assert set(ref._LAZY) == set(port._LAZY)
    assert set(ref._LAZY) <= set(dir(port))
    for name, mod in ref._LAZY.items():
        target = importlib.import_module(
            mod.replace("powersystemsreliabilityassessment_tpu",
                        "powersystemsreliabilityassessment_tpu_torch", 1))
        want = target if name == "cases" else getattr(target, name)
        assert getattr(port, name) is want, name
    with pytest.raises(AttributeError, match="no attribute"):
        port.not_an_entry_point
