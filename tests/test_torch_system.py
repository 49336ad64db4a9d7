"""PyTorch port: configuration, case data, component models and the
``System`` against the JAX reference package, and the port's import rule
(it never imports JAX)."""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.models import (
    twostate as ref_twostate)
from powersystemsreliabilityassessment_tpu.utils import config as ref_config

import powersystemsreliabilityassessment_tpu_torch as port
from powersystemsreliabilityassessment_tpu_torch.core import cases, system
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.utils import config

PORT_DIR = pathlib.Path(port.__file__).parent

# Host-built fields that the reference and the port compute with the
# same float64 numpy arithmetic and cast once: bit-equal.
EXACT_FIELDS = ["bus_pd", "gen_bus_onehot", "load_onehot", "load_pd",
                "incidence", "b_susceptance", "br_rate", "gen_pmax",
                "gen_pmin", "unavail", "mttf", "mttr", "always_up_nsq",
                "theta_bound"]
# Matrix inverses / products: same code, but held to 1e-6 (float32
# tolerance) so a BLAS with another summation order still passes.
FACTOR_FIELDS = ["ptdf", "lodf", "br_transfer"]


@pytest.fixture(scope="module")
def ref_sys():
    return ref_build_system(ref_cases.rts24())


@pytest.fixture(scope="module")
def port_sys():
    return system.build_system(cases.rts24(), device="cpu")


def test_case_data_matches_reference():
    a, b = ref_cases.rts24(), cases.rts24()
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, f.name
    assert (b.n_bus, b.n_gen, b.n_branch, b.n_comp) == (24, 33, 38, 71)
    assert b.sync_cond_mask.nonzero()[0].tolist() == [14]


def test_twostate_matches_reference():
    case = ref_cases.rts24()
    np.testing.assert_array_equal(ref_twostate.unavailability(case),
                                  twostate.unavailability(cases.rts24()))
    np.testing.assert_array_equal(ref_twostate.mean_times(case),
                                  twostate.mean_times(cases.rts24()))


@pytest.mark.parametrize("field", EXACT_FIELDS)
def test_build_system_exact_fields(ref_sys, port_sys, field):
    got = getattr(port_sys, field)
    assert got.device.type == "cpu"
    assert got.dtype == (torch.bool if field == "always_up_nsq"
                         else torch.float32)
    np.testing.assert_array_equal(np.asarray(getattr(ref_sys, field)),
                                  got.numpy())


@pytest.mark.parametrize("field", FACTOR_FIELDS)
def test_build_system_topology_factors(ref_sys, port_sys, field):
    np.testing.assert_allclose(getattr(port_sys, field).numpy(),
                               np.asarray(getattr(ref_sys, field)),
                               rtol=0, atol=1e-6)


def test_build_system_metadata(ref_sys, port_sys):
    for k in ("name", "n_bus", "n_gen", "n_branch", "n_load", "base_mva"):
        assert getattr(port_sys, k) == getattr(ref_sys, k), k
    assert port_sys.n_comp == ref_sys.n_comp == 71


def test_from_reference_is_exact(ref_sys):
    got = system.from_reference(ref_sys, device="cpu")
    for field in EXACT_FIELDS + FACTOR_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref_sys, field)),
                                      getattr(got, field).numpy())
    assert got.n_load == ref_sys.n_load and got.device.type == "cpu"


@pytest.mark.parametrize("name", ["CompatFlags", "IPMConfig", "MCSConfig"])
def test_config_defaults_match_reference(name):
    ours, theirs = getattr(config, name)(), getattr(ref_config, name)()
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


def test_full_precision_matmuls():
    # Port of reference __init__.py:33 (TF32 would round one-hot
    # scatters such as 265 MW -> 264 MW).
    assert port.CompatFlags is config.CompatFlags
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = sorted(PORT_DIR.rglob("*.py")) + [PORT_DIR.parent
                                             / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(str(p), mod) for p in files for mod in _imported_modules(p)
           if mod.split(".")[0] in ("jax", "jaxlib",
                                    "powersystemsreliabilityassessment_tpu")]
    assert bad == []
