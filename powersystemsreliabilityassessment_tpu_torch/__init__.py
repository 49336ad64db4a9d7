"""PyTorch + CUDA port of the bulk power-system reliability framework.

The JAX package ``powersystemsreliabilityassessment_tpu`` is the reference
this package mirrors module by module (same subpackages, same module
names); every public function names the reference function it ports.
Plain tensor code is PyTorch; the Pallas kernels on the ported path are
hand-written CUDA C++ for Hopper (``csrc/``), each with a plain PyTorch
version beside it that CPU tensors take.

Ported so far: the HL2 non-sequential Monte Carlo main path
(``studies.hl2_nsq.run_nsq_study``) on IEEE RTS-24 and, through the
blocked-Cholesky LP route for 72 < m <= 336, on IEEE RTS-96; the HL2
sequential study (``studies.hl2_seq.run_seq_study``) on IEEE RTS-24;
JSON checkpoints and resume for both; see ROADMAP.md for the rest. Entry points run on the card unless the caller
passes ``device="cpu"``.
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
