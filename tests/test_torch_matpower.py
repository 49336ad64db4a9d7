"""MATPOWER ``.m`` interop of the port (core/matpower_io.py).

Every case of tests/test_matpower.py through the port, then the port
against the reference: the same text parses to equal dicts, the same file
loads to equal ``CaseData`` arrays, ``save_matpower_case`` writes the
same bytes, and a file written by either package loads in the other.
"""
import dataclasses

import numpy as np
import pytest

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core import matpower_io as ref_mp
from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.matpower_io import (
    load_matpower_case, parse_matpower, resolve_case, save_matpower_case)

CPU = "cpu"
_FIELDS = ("bus_pd", "bus_qd", "gen_bus", "gen_pmax", "gen_pmin",
           "gen_mttf", "gen_mttr", "gen_maint_weeks", "br_from", "br_to",
           "br_x", "br_rate", "br_lambda", "br_dur")


def test_roundtrip_rts24_exact(tmp_path):
    case = cases.rts24()
    path = str(tmp_path / "rts24x.m")
    save_matpower_case(case, path)
    got = load_matpower_case(path)   # sibling failrate JSON auto-detected
    assert got.name == "rts24x"
    assert got.base_mva == case.base_mva
    for f in _FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(case, f),
                                   rtol=1e-9, err_msg=f)


def test_roundtrip_bus_area(tmp_path):
    case = cases.rts96()
    path = str(tmp_path / "r96.m")
    save_matpower_case(case, path)
    got = load_matpower_case(path)
    np.testing.assert_array_equal(got.bus_area, case.bus_area)
    single = cases.rts24()
    assert single.bus_area is None
    path1 = str(tmp_path / "r24.m")
    save_matpower_case(single, path1)
    assert load_matpower_case(path1).bus_area is None


def test_case_hl15_view_from_loaded_file(tmp_path):
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        multiarea_demo)
    case = cases.rts96()
    path = str(tmp_path / "r96b.m")
    save_matpower_case(case, path)
    sys_direct = multiarea_demo.case_system(case, hours=48)
    sys_loaded = multiarea_demo.case_system(load_matpower_case(path),
                                            hours=48)
    assert sys_loaded.area_names == sys_direct.area_names
    np.testing.assert_allclose(sys_loaded.tie_cap, sys_direct.tie_cap)
    np.testing.assert_allclose(sys_loaded.hourly_load,
                               sys_direct.hourly_load, rtol=1e-6)
    with pytest.raises(ValueError, match="no area structure"):
        multiarea_demo.case_system(cases.rts24(), hours=48)


def test_roundtrip_system_parity(tmp_path):
    """The loaded case builds the same electrical model (PTDF)."""
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags)
    case = cases.rts24()
    path = str(tmp_path / "rt.m")
    save_matpower_case(case, path)
    got = load_matpower_case(path)
    a = build_system(case, CompatFlags(), device=CPU)
    b = build_system(got, CompatFlags(), device=CPU)
    np.testing.assert_allclose(b.ptdf.numpy(), a.ptdf.numpy(), atol=1e-6)
    np.testing.assert_allclose(b.br_rate.numpy(), a.br_rate.numpy(),
                               rtol=1e-6)


def test_synthesized_reliability_class_rule(tmp_path):
    case = cases.rts24()
    path = str(tmp_path / "nofail.m")
    save_matpower_case(case, path, failrate_json=False)
    got = load_matpower_case(path)
    # Every RTS-24 Pmax is exactly an RTS-79 class: the synthesis gives
    # the published generator values.
    np.testing.assert_allclose(got.gen_mttf, case.gen_mttf)
    np.testing.assert_allclose(got.gen_mttr, case.gen_mttr)
    np.testing.assert_allclose(got.gen_maint_weeks, case.gen_maint_weeks)
    # Branches by endpoint-bus voltage class: save lifts both ends of a
    # rate >= 400 MW branch to 230 kV.
    kv_branch = np.where(case.br_rate >= 400.0, 230.0, 138.0)
    kv_bus = np.full(case.n_bus, 138.0)
    for ends in (case.br_from, case.br_to):
        np.maximum.at(kv_bus, ends, kv_branch)
    hi = np.maximum(kv_bus[case.br_from], kv_bus[case.br_to]) >= 200.0
    assert hi.any() and (~hi).any()
    np.testing.assert_allclose(got.br_lambda[hi], 0.38)
    np.testing.assert_allclose(got.br_dur[hi], 11.0)
    np.testing.assert_allclose(got.br_lambda[~hi], 0.37)
    np.testing.assert_allclose(got.br_dur[~hi], 10.0)


_SAMPLE = """\
function mpc = weird_case
% a comment line
mpc.version = '2';
mpc.baseMVA = 100;
mpc.bus = [
  10 3 50 10 0 0 1 1.0 0 138 1 1.05 0.95;
  20 1 80 16 0 0 1 1.0 0 138 1 1.05 0.95;  % trailing comment
  40 1  0  0 0 0 1 1.0 0 230 1 1.05 0.95
];
mpc.gen = [
  10 60 0 30 -30 1 100 1 ...
     60 12 0 0 0 0 0 0 0 0 0 0 0;
  20 99 0 30 -30 1 100 0 99 0 0 0 0 0 0 0 0 0 0 0 0;
  40 155 0 30 -30 1 100 1 155 54.25 0 0 0 0 0 0 0 0 0 0 0
];
mpc.branch = [
  10, 20, 0.01, 0.10, 0.0, 175, 0, 0, 0,   0, 1, -360, 360;
  20, 40, 0.01, 0.20, 0.0, 0,   0, 0, 1.05, 0, 1, -360, 360;
  10, 40, 0.01, 0.30, 0.0, 500, 0, 0, 0,   0, 0, -360, 360
];
"""


def test_parser_and_conventions(tmp_path):
    mpc = parse_matpower(_SAMPLE)
    assert mpc["version"] == "2"
    assert mpc["baseMVA"] == 100.0
    assert mpc["bus"].shape == (3, 13)
    assert mpc["gen"].shape == (3, 21)   # '...' continuation joined

    path = str(tmp_path / "weird_case.m")
    with open(path, "w") as f:
        f.write(_SAMPLE)
    case = load_matpower_case(path)
    assert case.n_bus == 3                       # buses 10/20/40 -> 0/1/2
    np.testing.assert_array_equal(case.bus_pd, [50.0, 80.0, 0.0])
    assert case.n_gen == 2 and case.n_branch == 2    # status 0 dropped
    np.testing.assert_array_equal(case.gen_bus, [0, 2])
    np.testing.assert_allclose(case.gen_pmax, [60.0, 155.0])
    np.testing.assert_allclose(case.br_x, [0.10, 0.20 * 1.05])   # tap
    assert case.br_rate[1] >= 4 * 130.0          # RATE_A 0: never binds
    assert case.br_rate[0] == 175.0
    np.testing.assert_allclose(case.gen_mttf, [1980.0, 960.0])
    np.testing.assert_allclose(case.br_lambda, [0.37, 0.38])


def test_reliability_size_mismatch(tmp_path):
    path = str(tmp_path / "weird_case.m")
    with open(path, "w") as f:
        f.write(_SAMPLE)
    with pytest.raises(ValueError, match="reliability arrays sized"):
        load_matpower_case(path, reliability={
            "genmttf": [1.0], "genmttr": [1.0],
            "brlambda": [0.1, 0.1], "brdur": [10.0, 10.0]})


def test_resolve_case(tmp_path):
    assert resolve_case("rts24").n_bus == 24
    assert resolve_case("case300s").n_bus == 300
    path = str(tmp_path / "rc.m")
    save_matpower_case(cases.rts24(), path)
    assert resolve_case(path).n_bus == 24
    with pytest.raises(SystemExit, match="unknown case"):
        resolve_case("nope")


# --- the port against the reference --------------------------------------

def _assert_same_case(a, b):
    assert a.name == b.name and a.base_mva == b.base_mva
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def _same_parse(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", ["sample", "rts24", "rts96", "case300s"])
def test_parse_and_load_equal_reference(tmp_path, name):
    path = tmp_path / f"{name}.m"
    if name == "sample":
        path.write_text(_SAMPLE)
    else:
        ref_mp.save_matpower_case(getattr(ref_cases, name)(), str(path),
                                  failrate_json=False)
    text = path.read_text()
    _same_parse(parse_matpower(text), ref_mp.parse_matpower(text))
    # The synthesis rule (no failrate JSON) and an explicit dict.
    _assert_same_case(load_matpower_case(str(path)),
                      ref_mp.load_matpower_case(str(path)))
    if name == "sample":
        rel = {"genmttf": [1.0, 2.0], "genmttr": [5.0, 6.0],
               "brlambda": [0.2, 0.3], "brdur": [7.0, 8.0]}
        _assert_same_case(load_matpower_case(str(path), reliability=rel),
                          ref_mp.load_matpower_case(str(path),
                                                    reliability=rel))


@pytest.mark.parametrize("name", ["rts24", "rts96", "case300s"])
def test_save_is_byte_identical_to_reference(tmp_path, name):
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    ours.mkdir()
    theirs.mkdir()
    save_matpower_case(getattr(cases, name)(), str(ours / f"{name}.m"))
    ref_mp.save_matpower_case(getattr(ref_cases, name)(),
                              str(theirs / f"{name}.m"))
    for fname in (f"{name}.m", f"{name}_failrate.json"):
        assert (ours / fname).read_bytes() == (theirs / fname).read_bytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_cross_load(tmp_path, writer):
    for name in ("rts24", "rts96", "case300s"):
        path = str(tmp_path / f"{writer}_{name}.m")
        if writer == "port":
            save_matpower_case(getattr(cases, name)(), path)
        else:
            ref_mp.save_matpower_case(getattr(ref_cases, name)(), path)
        _assert_same_case(load_matpower_case(path),
                          ref_mp.load_matpower_case(path))
        got = load_matpower_case(path)
        want = getattr(cases, name)()
        for f in _FIELDS:
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-9, err_msg=(name, f))
