"""Build and load the package's hand-written CUDA kernels.

The CUDA C++ sources in ``csrc/`` are compiled at first use by ``nvcc``
for Hopper (``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc``
process per source, all started together, and linked into one shared
library with a plain C interface, bound with ``ctypes``. The library is
cached in ``_build/`` inside the package directory (listed in
``.gitignore``) under a name that hashes the sources, so an edited
source is rebuilt and a stale library is never loaded. Nothing here runs
at import time: a machine without ``nvcc`` or a card imports the package
and uses the kernels' plain PyTorch versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
# Filled by the first load: wall seconds spent building (0.0 when the
# cached library was reused) and the compiler's per-kernel resource
# report (registers, shared memory, spills).
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "psra_cholesky": [_P, _P] + [_I] * 5 + [_P],
    "psra_cho_solve": [_P, _P, _P, _I, _I, _P],
    "psra_fused_ipm": [_P] * 19 + [_I] * 9 + [_F] * 4 + [_P],
    "psra_fused_ipm_occupancy": [_I] * 5 + [_P],
    "psra_trsm": [_P, _P, _P, _I, _I, _I, _I, _P],
    "psra_bernoulli": [_P, _P, _P, _I, _I, _P],
    "psra_fused_sampler_cert": [_P] * 5 + [_I] * 7 + [_F] + [_P] * 5,
    "psra_certify": [_P] * 4 + [_I] * 8 + [_P] * 6,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on the machine with the card")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        _lib = _build_and_load()
    return _lib


def _build_and_load() -> ctypes.CDLL:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so = BUILD_DIR / f"libpsra_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    report = ""
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        # communicate() waits for each one, so none outlives this call.
        errs = [proc.communicate()[1] for proc in procs]
        cmds.append([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                     *map(str, objs)])
        rcs = [proc.returncode for proc in procs]
        if not any(rcs):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            errs.append(link.stderr)
            rcs.append(link.returncode)
        for cmd, err, rc in zip(cmds, errs, rcs):
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}"
                                   f"\n{err}")
        report = "".join(errs)
        for obj in objs:
            obj.unlink()
        os.replace(tmp, so)   # atomic: a concurrent process never loads a partial file
    build_info.update(seconds=time.perf_counter() - t0, library=so.name,
                      ptxas=report)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer value.
    Read raw (PyTorch's own generated kernels read it so): building a
    ``torch.cuda.Stream`` object costs ~4 us of host time, as much as a
    small kernel's launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_operand(t: torch.Tensor, name: str, shape: tuple,
                  dtype: torch.dtype = torch.float32) -> None:
    """Validate a kernel operand: CUDA, ``dtype`` (float32 unless
    named), contiguous, ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {str(dtype)[6:]}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
