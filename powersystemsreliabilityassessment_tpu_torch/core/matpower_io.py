"""MATPOWER case-file interop: load and save ``.m`` cases as ``CaseData``.

Port of ``powersystemsreliabilityassessment_tpu/core/matpower_io.py``
(``parse_matpower``, ``_synthesize_gen_reliability``,
``_synthesize_branch_reliability``, ``load_matpower_case``,
``save_matpower_case``, ``resolve_case``), unchanged: it is host-side
numpy over the port's own ``core/cases.py::CaseData``.

The reference's solver path accepts arbitrary MATPOWER cases through
``loadcase`` (reference ``README.md:47-49``, ``nsqMain.m:42``) and keeps
reliability data in a separate failure-rate struct
(``Montecarlo_*/case24_failrate.m``: ``genmttf/genmttr/brlambda/brdur``).

* :func:`load_matpower_case` parses a MATPOWER ``.m`` file (format v2)
  into :class:`~.cases.CaseData`. Reliability comes from (first match
  wins)

  1. an explicit ``reliability=`` dict / JSON path with the failrate
     struct's keys (``genmttf``, ``genmttr``, ``brlambda``, ``brdur``,
     optional ``genmaintweeks``),
  2. a sibling ``<case>_failrate.json`` next to the ``.m`` file,
  3. the **RTS-79 class synthesis rule** (public cases such as
     MATPOWER's ``case300`` ship no reliability data): each generator
     takes the MTTF / MTTR / maintenance of the RTS-79 unit class nearest
     in Pmax; each branch takes the RTS-79 line class of its voltage
     level (>= 200 kV: the 230 kV class, lambda 0.38/yr, 11 h; otherwise
     the 138 kV overhead median, lambda 0.37/yr, 10 h), the convention of
     :func:`~.cases.case300s` / :func:`~.cases.rts96`.

* :func:`save_matpower_case` writes a ``CaseData`` back out as a MATPOWER
  ``.m`` plus the sibling failrate JSON, so cases round-trip losslessly.
  Its files are byte-identical to the reference's, header comment
  included, so a case file written by either package is the same file.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np

from .cases import CaseData

# MATPOWER column indices (matpower/lib/idx_bus.m etc., 0-based).
_BUS_I, _BUS_PD, _BUS_QD, _BUS_AREA, _BUS_BASEKV = 0, 2, 3, 6, 9
_GEN_BUS, _GEN_STATUS, _GEN_PMAX, _GEN_PMIN = 0, 7, 8, 9
_BR_F, _BR_T, _BR_X, _BR_RATEA, _BR_TAP, _BR_STATUS = 0, 1, 3, 5, 8, 10

# RTS-79 unit classes (Pmax MW -> MTTF h, MTTR h, maintenance weeks/yr),
# exactly the per-unit-type data of cases.rts24 / case24_failrate.m:23-78.
# Pmax 0 is the synchronous-condenser class.
_GEN_CLASSES = np.array([
    (0.0, 10000.0, 0.1, 0.1),
    (12.0, 2940.0, 60.0, 2.0),
    (20.0, 450.0, 50.0, 2.0),
    (50.0, 1980.0, 20.0, 2.0),
    (76.0, 1960.0, 40.0, 3.0),
    (100.0, 1200.0, 50.0, 3.0),
    (155.0, 960.0, 40.0, 4.0),
    (197.0, 950.0, 50.0, 4.0),
    (350.0, 1150.0, 100.0, 5.0),
    (400.0, 1100.0, 150.0, 6.0),
])
# RTS-79 line classes: (lambda occ/yr, repair h). The 138 kV figures are
# the medians over rts24's 138 kV overhead rows; 230 kV as in rts96 ties.
_LINE_230 = (0.38, 11.0)
_LINE_138 = (0.37, 10.0)


def parse_matpower(text: str) -> dict:
    """Parse MATPOWER ``.m`` source into ``{field: scalar | 2-D array}``;
    mirrors reference ``core/matpower_io.py::parse_matpower``.

    Tolerates comments, ``...`` continuations, tabs, comma separators and
    an arbitrary struct variable name (``function mpc = casename``).
    String fields (``version``) are returned as Python strings.
    """
    fn = re.search(r"function\s+(?:\[?\s*)?(\w+)\s*\]?\s*=", text)
    var = fn.group(1) if fn else "mpc"
    text = re.sub(r"%[^\n]*", "", text)
    # A '...' continuation joins the NEXT line (newline is otherwise a
    # row separator inside [..] matrices), so consume trailing whitespace
    # including the newline itself.
    text = re.sub(r"\.\.\.\s*", " ", text)

    out: dict = {}
    for m in re.finditer(
            rf"{re.escape(var)}\.(\w+)\s*=\s*(\[.*?\]|'[^']*'|[^;]+);",
            text, re.S):
        name, body = m.group(1), m.group(2).strip()
        if body.startswith("'"):
            out[name] = body.strip("'")
            continue
        if body.startswith("["):
            rows = []
            for row in re.split(r"[;\n]", body.strip("[]")):
                vals = [v for v in re.split(r"[,\s]+", row.strip()) if v]
                if vals:
                    rows.append([float(v) for v in vals])
            if not rows:
                out[name] = np.zeros((0, 0))
                continue
            ncol = max(len(r) for r in rows)
            if any(len(r) != ncol for r in rows):
                raise ValueError(
                    f"ragged matrix for {var}.{name}: row lengths "
                    f"{sorted({len(r) for r in rows})}")
            out[name] = np.asarray(rows, dtype=np.float64)
            continue
        try:
            out[name] = float(body)
        except ValueError:
            out[name] = body
    return out


def _synthesize_gen_reliability(pmax: np.ndarray):
    """RTS-79 nearest-Pmax class rule (module docstring); mirrors
    reference ``_synthesize_gen_reliability``."""
    d = np.abs(pmax[:, None] - _GEN_CLASSES[None, :, 0])
    cls = np.argmin(d, axis=1)
    return (_GEN_CLASSES[cls, 1], _GEN_CLASSES[cls, 2],
            _GEN_CLASSES[cls, 3])


def _synthesize_branch_reliability(kv: np.ndarray):
    """RTS-79 voltage-class rule, unknown kv (<= 0) -> the 230 kV class;
    mirrors reference ``_synthesize_branch_reliability``."""
    hi = (kv >= 200.0) | (kv <= 0.0)
    lam = np.where(hi, _LINE_230[0], _LINE_138[0])
    dur = np.where(hi, _LINE_230[1], _LINE_138[1])
    return lam, dur


def load_matpower_case(path: str, reliability=None,
                       name: str | None = None) -> CaseData:
    """Load a MATPOWER ``.m`` case file as :class:`CaseData`; mirrors
    reference ``core/matpower_io.py::load_matpower_case``.

    Reliability resolution order: explicit ``reliability`` (dict or JSON
    path with the reference failrate-struct keys), sibling
    ``<stem>_failrate.json``, RTS-79 class synthesis (module docstring).
    Reliability arrays index the IN-SERVICE components in file order
    (out-of-service rows are dropped first, like the reference's
    MATPOWER ``ext2int``).

    DC-model conventions: out-of-service gens/branches dropped;
    transformer off-nominal taps fold into the series reactance
    (``x_eff = x * tap``); phase shifts are ignored (none of the
    reference's cases carry them); ``RATE_A <= 0`` ("unlimited" in
    MATPOWER) becomes a finite never-binding rating — ``4x`` system
    peak — because the angle-box preconditioner (system.py theta_bound)
    derives per-bus bounds from ``rate * x`` path sums, and a 1e5-class
    sentinel would re-open the wide-box conditioning problem it exists
    to close.
    """
    with open(path) as f:
        mpc = parse_matpower(f.read())
    for req in ("bus", "gen", "branch"):
        if req not in mpc or not isinstance(mpc[req], np.ndarray):
            raise ValueError(f"{path}: missing mpc.{req}")
    bus, gen, br = mpc["bus"], mpc["gen"], mpc["branch"]
    base = float(mpc.get("baseMVA", 100.0))

    bus_ids = bus[:, _BUS_I].astype(np.int64)
    if len(set(bus_ids.tolist())) != len(bus_ids):
        raise ValueError(f"{path}: duplicate bus numbers")
    idx_of = {int(b): i for i, b in enumerate(bus_ids)}

    gon = gen[:, _GEN_STATUS] > 0 if gen.shape[1] > _GEN_STATUS else (
        np.ones(gen.shape[0], dtype=bool))
    gen = gen[gon]
    bon = br[:, _BR_STATUS] > 0 if br.shape[1] > _BR_STATUS else (
        np.ones(br.shape[0], dtype=bool))
    br = br[bon]

    def to_idx(col, what):
        try:
            return np.asarray([idx_of[int(b)] for b in col], np.int32)
        except KeyError as e:
            raise ValueError(f"{path}: {what} references unknown bus "
                             f"{e.args[0]}") from None

    gen_pmax = gen[:, _GEN_PMAX].astype(np.float64)
    gen_pmin = np.clip(gen[:, _GEN_PMIN], 0.0, np.maximum(gen_pmax, 0.0))

    tap = (br[:, _BR_TAP] if br.shape[1] > _BR_TAP
           else np.zeros(br.shape[0]))
    br_x = br[:, _BR_X] * np.where(tap > 0, tap, 1.0)
    rate = br[:, _BR_RATEA].astype(np.float64)
    unlimited = max(4.0 * float(bus[:, _BUS_PD].sum()),
                    2.0 * float(rate.max(initial=0.0)), 1.0)
    rate = np.where(rate > 0, rate, unlimited)

    rel = reliability
    if rel is None:
        sibling = os.path.splitext(path)[0] + "_failrate.json"
        if os.path.exists(sibling):
            rel = sibling
    if isinstance(rel, (str, os.PathLike)):
        with open(rel) as f:
            rel = json.load(f)
    if rel is not None:
        mttf = np.asarray(rel["genmttf"], np.float64)
        mttr = np.asarray(rel["genmttr"], np.float64)
        lam = np.asarray(rel["brlambda"], np.float64)
        dur = np.asarray(rel["brdur"], np.float64)
        weeks = np.asarray(rel.get("genmaintweeks",
                                   _synthesize_gen_reliability(gen_pmax)[2]),
                           np.float64)
        if mttf.shape[0] != gen.shape[0] or lam.shape[0] != br.shape[0]:
            raise ValueError(
                f"{path}: reliability arrays sized "
                f"({mttf.shape[0]} gens, {lam.shape[0]} branches) but the "
                f"case has ({gen.shape[0]}, {br.shape[0]}) in service")
    else:
        mttf, mttr, weeks = _synthesize_gen_reliability(gen_pmax)
        kv = np.maximum(bus[to_idx(br[:, _BR_F], "branch"), _BUS_BASEKV],
                        bus[to_idx(br[:, _BR_T], "branch"), _BUS_BASEKV])
        lam, dur = _synthesize_branch_reliability(kv)

    # BUS_AREA column -> 0-based contiguous area indices (np.unique order,
    # i.e. ascending MATPOWER area number); None when single-area.
    bus_area = None
    if bus.shape[1] > _BUS_AREA:
        _, inv = np.unique(bus[:, _BUS_AREA].astype(np.int64),
                           return_inverse=True)
        if inv.max() > 0:
            bus_area = inv.astype(np.int64)

    return CaseData(
        name=name or os.path.splitext(os.path.basename(path))[0],
        base_mva=base,
        bus_pd=bus[:, _BUS_PD].astype(np.float64),
        bus_qd=bus[:, _BUS_QD].astype(np.float64),
        bus_area=bus_area,
        gen_bus=to_idx(gen[:, _GEN_BUS], "gen"),
        gen_pmax=gen_pmax,
        gen_pmin=gen_pmin,
        gen_mttf=mttf,
        gen_mttr=mttr,
        gen_maint_weeks=weeks,
        br_from=to_idx(br[:, _BR_F], "branch"),
        br_to=to_idx(br[:, _BR_T], "branch"),
        br_x=br_x.astype(np.float64),
        br_rate=rate,
        br_lambda=lam,
        br_dur=dur,
    )


def save_matpower_case(case: CaseData, path: str,
                       failrate_json: bool = True) -> None:
    """Write ``case`` as a MATPOWER ``.m`` + sibling failrate JSON;
    mirrors reference ``core/matpower_io.py::save_matpower_case``.

    BASE_KV is not stored in CaseData; it is emitted by the same rating
    convention the synthesis rule assumes (rate >= 400 MW -> 230 kV,
    else 138 kV) so save->load without the JSON stays self-consistent.
    """
    nb, ng, nl = case.n_bus, case.n_gen, case.n_branch
    kv_branch = np.where(case.br_rate >= 400.0, 230.0, 138.0)
    kv_bus = np.full(nb, 138.0)
    for ends, kv in zip((case.br_from, case.br_to), (kv_branch,) * 2):
        np.maximum.at(kv_bus, ends, kv)

    fname = re.sub(r"\W", "_", os.path.splitext(os.path.basename(path))[0])
    lines = [f"function mpc = {fname}",
             # The reference's header line: the two packages write the
             # same bytes.
             f"%% {case.name}: exported by "
             "powersystemsreliabilityassessment_tpu.core.matpower_io",
             "mpc.version = '2';",
             f"mpc.baseMVA = {case.base_mva:g};", "", "mpc.bus = ["]
    area = (case.bus_area + 1 if case.bus_area is not None
            else np.ones(nb, np.int64))                  # BUS_AREA col
    for i in range(nb):
        lines.append(
            f"\t{i + 1}\t{3 if i == 0 else 1}\t{case.bus_pd[i]:g}\t"
            f"{case.bus_qd[i]:g}\t0\t0\t{int(area[i])}\t1\t0\t"
            f"{kv_bus[i]:g}\t1\t1.05\t0.95;")
    lines += ["];", "", "mpc.gen = ["]
    for i in range(ng):
        lines.append(
            f"\t{int(case.gen_bus[i]) + 1}\t{case.gen_pmax[i]:g}\t0\t"
            f"9999\t-9999\t1\t{case.base_mva:g}\t1\t{case.gen_pmax[i]:g}"
            f"\t{case.gen_pmin[i]:g}" + "\t0" * 11 + ";")
    lines += ["];", "", "mpc.branch = ["]
    for i in range(nl):
        lines.append(
            f"\t{int(case.br_from[i]) + 1}\t{int(case.br_to[i]) + 1}\t0\t"
            f"{case.br_x[i]:.10g}\t0\t{case.br_rate[i]:g}\t0\t0\t0\t0\t1"
            "\t-360\t360;")
    lines += ["];", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))

    if failrate_json:
        sib = os.path.splitext(path)[0] + "_failrate.json"
        with open(sib, "w") as f:
            json.dump({
                "genmttf": case.gen_mttf.tolist(),
                "genmttr": case.gen_mttr.tolist(),
                "genmaintweeks": case.gen_maint_weeks.tolist(),
                "brlambda": case.br_lambda.tolist(),
                "brdur": case.br_dur.tolist(),
            }, f, indent=1)


def resolve_case(name_or_path: str) -> CaseData:
    """CLI case resolver: a builtin constructor name from the port's
    :mod:`.cases` (``rts24``/``rts96``/``case300s``...) or a path to a
    MATPOWER ``.m`` file (the reference's ``loadcase`` entry point,
    nsqMain.m:42); mirrors reference ``core/matpower_io.py::resolve_case``."""
    if name_or_path.endswith(".m") or os.path.sep in name_or_path:
        return load_matpower_case(name_or_path)
    from . import cases
    ctor = getattr(cases, name_or_path, None)
    if ctor is None:
        raise SystemExit(
            f"unknown case {name_or_path!r}: not a builtin "
            "(rts24/rts96/case300s/...) nor a .m file path")
    return ctor()


__all__ = ["parse_matpower", "load_matpower_case", "save_matpower_case",
           "resolve_case"]
