"""PyTorch + CUDA port of the bulk power-system reliability framework.

The JAX package ``powersystemsreliabilityassessment_tpu`` is the reference
this package mirrors module by module (same subpackages, same module
names); every public function names the reference function it ports.
Plain tensor code is PyTorch; the Pallas kernels on the ported path are
hand-written CUDA C++ for Hopper (``csrc/``), each with a plain PyTorch
version beside it that CPU tensors take.

Ported: the HL2 non-sequential and sequential studies with every
sampler and option, multilevel splitting, the large-m path, HL1,
planning, ELU, Markov, the multi-area engine, MATPOWER case files, JSON
checkpoints, the report figures, the command line (``python -m
powersystemsreliabilityassessment_tpu_torch``) and the scenario mesh
(``parallel/mesh.py``: one process per device under torchrun, one
``all_reduce`` of the partials a step, for the NSQ, SEQ, split-SEQ,
multi-area and HL1 Monte Carlo). Entry points run on the card unless the
caller passes ``device="cpu"``, or on every rank of a mesh
(``scenario_mesh``) where the caller passes ``mesh=``.
"""

__version__ = "0.1.0"

import torch as _torch

# Port of the reference's ``jax_default_matmul_precision = "highest"``
# (reference ``__init__.py:33``): reduced-precision matmuls once rounded
# 265 MW to 264 MW in one-hot scatters. TF32 keeps ~3 decimal digits, so
# both the matmul and the cuDNN switch go off, and float32 matmuls run
# in full float32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from powersystemsreliabilityassessment_tpu_torch.utils.config import (  # noqa: E402,F401
    CompatFlags,
    IPMConfig,
    MCSConfig,
)

# Lazy top-level API (PEP 562), as the reference's (``__init__.py:45-76``):
# the study and engine entry points without importing their modules at
# package import. ``import powersystemsreliabilityassessment_tpu_torch as
# psra; psra.run_nsq_study(psra.cases.rts24())`` runs on the card.
_LAZY = {
    "cases": "powersystemsreliabilityassessment_tpu_torch.core.cases",
    "build_system":
        "powersystemsreliabilityassessment_tpu_torch.core.system",
    "load_matpower_case":
        "powersystemsreliabilityassessment_tpu_torch.core.matpower_io",
    "resolve_case":
        "powersystemsreliabilityassessment_tpu_torch.core.matpower_io",
    "evaluate_states":
        "powersystemsreliabilityassessment_tpu_torch.engines.dcopf",
    "evaluate_states_screened":
        "powersystemsreliabilityassessment_tpu_torch.engines.dcopf",
    "run_nsq_study":
        "powersystemsreliabilityassessment_tpu_torch.studies.hl2_nsq",
    "run_seq_study":
        "powersystemsreliabilityassessment_tpu_torch.studies.hl2_seq",
    "scenario_mesh":
        "powersystemsreliabilityassessment_tpu_torch.parallel.mesh",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name])
        obj = mod if name == "cases" else getattr(mod, name)
        globals()[name] = obj
        return obj
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
