"""Reporting: CSV / JSON / .mat export in the reference's schemas.

Port of the export half of
``powersystemsreliabilityassessment_tpu/utils/report.py``:

* ``nodal_results.csv``: ``BusID,EENS_MWh_yr`` (nsqMain.m:395-400 /
  seqMain.m:252-257);
* the result's ``to_dict()`` as JSON and as a MATLAB ``.mat``
  (nsqMain.m:404-405, seqMain.m:261-262 save ``.mat`` files).

The figures (matplotlib) are not ported yet (ROADMAP.md Queue 1 item 2):
``export_study(make_plots=True)`` raises NotImplementedError rather than
skip them quietly. Everything here runs on the host.
"""
from __future__ import annotations

import csv
import json
import os

import numpy as np


def export_nodal_csv(path: str, nodal_eens_mwh_yr: np.ndarray) -> None:
    """``BusID,EENS_MWh_yr`` rows, buses 1-based. Mirrors reference
    ``utils/report.py::export_nodal_csv``."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["BusID", "EENS_MWh_yr"])
        for i, v in enumerate(np.asarray(nodal_eens_mwh_yr), start=1):
            w.writerow([i, float(v)])


def export_json(path: str, result_dict: dict) -> None:
    """Mirrors reference ``utils/report.py::export_json``."""
    with open(path, "w") as f:
        json.dump(result_dict, f, indent=2)


def component_label(idx0: int, n_gen: int) -> str:
    """0-based component index -> the reference's 'Gen k' / 'Line k'
    label. Mirrors reference ``utils/report.py::component_label``."""
    return (f"Gen {idx0 + 1}" if idx0 < n_gen
            else f"Line {idx0 - n_gen + 1}")


def top_components(importance: np.ndarray, n_gen: int, k: int = 5):
    """The ``k`` most important components as (label, importance).
    Mirrors reference ``utils/report.py::top_components``."""
    order = np.argsort(-importance)[:k]
    return [(component_label(int(i), n_gen), float(importance[i]))
            for i in order]


def export_mat(path: str, result_dict: dict) -> None:
    """MATLAB .mat export of a study result (``scipy.io.savemat``);
    mirrors reference ``utils/report.py::export_mat``. Scalars and
    history / nodal vectors become doubles; ``None`` and empty lists are
    dropped (savemat cannot hold them)."""
    from scipy.io import savemat
    clean = {}
    for k, v in result_dict.items():
        if v is None or (isinstance(v, (list, tuple)) and len(v) == 0):
            continue
        clean[k] = np.asarray(v, dtype=np.float64) \
            if not np.isscalar(v) else float(v)
    savemat(path, clean)


def export_study(result, out_dir: str, prefix: str,
                 make_plots: bool = True, **plot_kw) -> None:
    """``{prefix}_nodal_results.csv``, ``{prefix}_results.json`` and
    ``{prefix}_reliability_results.mat`` for an NSQ / SEQ result; mirrors
    reference ``utils/report.py::export_study``. ``make_plots=True``
    raises NotImplementedError: the figures are not ported yet."""
    if make_plots:
        raise NotImplementedError(
            "the study figures (matplotlib) are not ported yet (ROADMAP.md "
            "Queue 1 item 2); pass make_plots=False")
    os.makedirs(out_dir, exist_ok=True)
    export_nodal_csv(os.path.join(out_dir, f"{prefix}_nodal_results.csv"),
                     result.nodal_eens_mwh_yr)
    export_json(os.path.join(out_dir, f"{prefix}_results.json"),
                result.to_dict())
    export_mat(os.path.join(out_dir, f"{prefix}_reliability_results.mat"),
               result.to_dict())
