"""Wall time to build the PyTorch port's CUDA kernels, three ways.

* ``single``: one ``nvcc`` over every source (nvcc compiles them one
  after another) that also links the shared library;
* ``serial``: one ``nvcc -c`` per source, one after another, then the
  link;
* ``parallel``: one ``nvcc -c`` per source, all started together, then
  the link: what ``ops/cuda_build.py`` does.

Each build goes to a fresh directory under the package's gitignored
``_build/`` and is removed after. Needs ``nvcc``; no card.

Usage: python scripts/torch_build_time.py
Prints one JSON line: seconds per way and the number of sources.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from powersystemsreliabilityassessment_tpu_torch.ops import (  # noqa: E402
    cuda_build as cb)


def _run_all(cmds: list, together: bool) -> None:
    if together:
        procs = [subprocess.Popen(c, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL) for c in cmds]
        rcs = [p.wait() for p in procs]
    else:
        rcs = [subprocess.run(c, capture_output=True).returncode
               for c in cmds]
    if any(rcs):
        raise RuntimeError(f"nvcc failed: {rcs}")


def build_seconds(way: str, out: Path) -> float:
    sources = sorted(cb.CSRC.glob("*.cu"))
    nvcc, so = cb._nvcc(), out / "lib.so"
    t0 = time.perf_counter()
    if way == "single":
        _run_all([[nvcc, *cb.NVCC_FLAGS, "-shared", "-o", str(so),
                   *map(str, sources)]], together=False)
    else:
        objs = [out / f"{src.stem}.o" for src in sources]
        _run_all([[nvcc, *cb.NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources, objs)],
                 together=way == "parallel")
        _run_all([[nvcc, *cb.ARCH_FLAGS, "-shared", "-o", str(so),
                   *map(str, objs)]], together=False)
    return time.perf_counter() - t0


def main() -> None:
    result = {"sources": len(list(cb.CSRC.glob("*.cu")))}
    for way in ("parallel", "serial", "single"):
        out = cb.BUILD_DIR / f"timing_{way}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        try:
            result[f"{way}_s"] = build_seconds(way, out)
        finally:
            shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
