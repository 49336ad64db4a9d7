"""Convergence-loop checkpointing (preemption recovery).

Port of ``powersystemsreliabilityassessment_tpu/runtime/checkpoint.py``
(``Checkpointer``, the JSON backend). The reference's MATLAB saves
results only at completion (nsqMain.m:404-405, seqMain.m:261-262). Here
the small host state (float64 accumulators, histories, the batch
counter and the LP buffer size) is written atomically every K batches;
a batch's draws depend only on (seed, batch index), so no device state
is saved and a resumed study equals an uninterrupted one.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def _to_jsonable(obj):
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tolist()}
    if isinstance(obj, (np.floating, np.integer)):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def _from_jsonable(obj):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return np.asarray(obj["__ndarray__"], dtype=np.float64)
        return {k: _from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_jsonable(v) for v in obj]
    return obj


class Checkpointer:
    """Atomic JSON checkpointing of host state; mirrors reference
    ``runtime/checkpoint.py::Checkpointer``. ``save`` writes a temporary
    file beside ``path`` and moves it over ``path`` with ``os.replace``,
    so a reader sees the old file or the new one, never half of one."""

    def __init__(self, path: str):
        self.path = path

    def save(self, state: dict) -> None:
        folder = os.path.dirname(self.path) or "."
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, suffix=".ckpt.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(_to_jsonable(state), f)
        os.replace(tmp, self.path)

    def restore(self) -> dict | None:
        """The last saved state (arrays as float64 numpy), or None."""
        if not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            return _from_jsonable(json.load(f))

    def clear(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)
