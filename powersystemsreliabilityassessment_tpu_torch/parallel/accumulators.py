"""Reliability-index accumulators: device partial sums, host float64 stats.

Port of ``powersystemsreliabilityassessment_tpu/parallel/accumulators.py``
(``BatchMoments``, ``batch_moments``, ``RunningStats``, ``AnnualStats``).
Each batch's partial sums are taken on the device; the host folds them
into float64 running statistics and evaluates the beta (NSQ) or CoV
(SEQ) stopping rule. Both host accumulators round-trip through the JSON
checkpoints of ``runtime/checkpoint.py`` (``state`` / ``from_state``).
On a scenario mesh (``parallel/mesh.py``) ``psum_moments`` sums a
batch's partials over the ranks in one ``all_reduce`` before the host
reads them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.parallel import (
    mesh as meshlib)


class BatchMoments(NamedTuple):
    """Partial sums over one batch; mirrors reference ``BatchMoments``.
    Fields are device tensors after ``batch_moments`` and float64 numpy
    values once fetched (``RunningStats.update`` takes either)."""
    n: object             # sample count
    sum_dns: object       # sum of DNS (MW), or of control-variate residuals
    sum_dns_sq: object    # sum of squares of the same
    sum_flag: object      # failure count (or residuals)
    sum_nodal: object     # [nb] sum of nodal shed (MW)
    sum_comp_fail: object  # [n_comp] comp-down counts over failure states
    sum_flag_raw: object  # raw failure count (importance denominator)


def batch_moments(dns_mw, nodal_mw, failure, comp_down, weight=None,
                  cv=None) -> BatchMoments:
    """Partial sums of one batch; mirrors reference
    ``parallel/accumulators.py::batch_moments``.

    ``weight`` [B] (importance sampling): DNS, nodal shed and failure
    flags are weighted while ``n`` stays the sample count, so the host's
    mean and beta are the importance-sampling estimator and its CoV;
    ``sum_flag_raw`` is the weighted (non-residual) flag sum, the
    denominator of component importance.

    ``cv = (c_mw, c_flag)``: the DNS/flag sums and second moment track
    the RESIDUALS ``w (dns - c)`` / ``w (flag - c_flag)`` (w = 1 without
    a weight), and ``RunningStats.mu_dns`` / ``mu_flag`` add the exact
    means back on the host. Keeping the device sums residual-only
    matters: float32 accumulation of sum((r + mu)^2) loses the whole
    residual variance to cancellation (the reference's silent early
    stop, NEXT.md #11).
    """
    f = failure.to(dns_mw.dtype)
    if weight is not None:
        dns_mw = dns_mw * weight
        nodal_mw = nodal_mw * weight[:, None]
        f = f * weight
    v, vf = dns_mw, f
    if cv is not None:
        c_mw, c_flag = cv
        c_flag = c_flag.to(dns_mw.dtype)
        if weight is not None:
            c_mw, c_flag = c_mw * weight, c_flag * weight
        v = dns_mw - c_mw
        vf = f - c_flag
    return BatchMoments(
        n=dns_mw.new_full((), float(dns_mw.shape[0])),
        sum_dns=v.sum(), sum_dns_sq=(v * v).sum(), sum_flag=vf.sum(),
        sum_nodal=nodal_mw.sum(0),
        sum_comp_fail=f @ comp_down.to(dns_mw.dtype),
        sum_flag_raw=f.sum())


def pack_moments(m: BatchMoments, *extra) -> torch.Tensor:
    """``m``'s fields and the scalars ``extra`` as one flat vector: n,
    sum_dns, sum_dns_sq, sum_flag, sum_flag_raw, ``extra``, sum_nodal,
    sum_comp_fail (the layout the NSQ study fetches and sums over the
    mesh)."""
    return torch.cat([
        torch.stack([m.n, m.sum_dns, m.sum_dns_sq, m.sum_flag,
                     m.sum_flag_raw, *extra]),
        m.sum_nodal, m.sum_comp_fail])


def unpack_moments(v, nb: int, n_extra: int = 0):
    """Inverse of :func:`pack_moments` on a tensor or a numpy vector (the
    fields are views): ``(BatchMoments, extra tuple)``; ``nb`` is the
    length of ``sum_nodal``."""
    k = 5 + n_extra
    return (BatchMoments(n=v[0], sum_dns=v[1], sum_dns_sq=v[2],
                         sum_flag=v[3], sum_nodal=v[k:k + nb],
                         sum_comp_fail=v[k + nb:], sum_flag_raw=v[4]),
            tuple(v[5:k]))


def psum_moments(mesh, m: BatchMoments) -> BatchMoments:
    """Every field of ``m`` summed over the scenario mesh ``mesh`` in ONE
    ``all_reduce`` of the packed fields; mirrors reference
    ``parallel/accumulators.py::psum_moments`` (a ``psum`` per field
    inside ``shard_map``). ``m`` itself on a mesh without a group."""
    if mesh.group is None:
        return m
    flat = meshlib.psum(mesh, pack_moments(m))
    return unpack_moments(flat, m.sum_nodal.shape[0])[0]


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


@dataclasses.dataclass
class RunningStats:
    """Host-side float64 cross-batch accumulator (NSQ path); mirrors
    reference ``parallel/accumulators.py::RunningStats``.

    Under a control variate the dns/flag sums hold residuals and
    ``mu_dns`` / ``mu_flag`` carry the exact means added back when
    reporting. Under the enumeration hybrid the device sums hold
    tail-masked values and the ``mu_*`` fields carry the exact enumerated
    parts, ``mu_nodal`` / ``mu_comp_fail`` / ``mu_flag_raw`` included.
    All default to 0 or None (plain Monte Carlo).
    """

    n: float = 0.0
    sum_dns: float = 0.0
    sum_dns_sq: float = 0.0
    sum_flag: float = 0.0
    sum_nodal: np.ndarray | None = None
    sum_comp_fail: np.ndarray | None = None
    mu_dns: float = 0.0
    mu_flag: float = 0.0
    sum_flag_raw: float = 0.0
    mu_nodal: np.ndarray | None = None
    mu_comp_fail: np.ndarray | None = None
    mu_flag_raw: float = 0.0

    def update(self, m: BatchMoments) -> None:
        m = BatchMoments(*(_f64(a) for a in m))
        self.n += float(m.n)
        self.sum_dns += float(m.sum_dns)
        self.sum_dns_sq += float(m.sum_dns_sq)
        self.sum_flag += float(m.sum_flag)
        self.sum_flag_raw += float(m.sum_flag_raw)
        self.sum_nodal = (m.sum_nodal if self.sum_nodal is None
                          else self.sum_nodal + m.sum_nodal)
        self.sum_comp_fail = (m.sum_comp_fail if self.sum_comp_fail is None
                              else self.sum_comp_fail + m.sum_comp_fail)

    @property
    def edns(self) -> float:
        return self.mu_dns + self.sum_dns / max(self.n, 1.0)

    @property
    def plc(self) -> float:
        return self.mu_flag + self.sum_flag / max(self.n, 1.0)

    def lole(self, hours_per_year: float = 8760.0) -> float:
        return self.plc * hours_per_year

    @property
    def beta(self) -> float:
        """Coefficient of variation of the EDNS estimator (nsqMain.m:297-301):
        sqrt(sum (dns - mean)^2) / (N * EDNS), the spread taken from the
        (residual) moments and the mean including the offset."""
        mean = self.edns
        if self.n <= 0 or mean <= 0:
            return float("inf")
        rbar = self.sum_dns / self.n
        ss = max(self.sum_dns_sq - self.n * rbar * rbar, 0.0)
        if ss == 0.0 and self.mu_dns > 0.0:
            # Residual mode with no residual variance observed yet:
            # convergence cannot be assessed.
            return float("inf")
        return float(np.sqrt(ss) / (self.n * mean))

    def nodal_eens(self, hours_per_year: float = 8760.0) -> np.ndarray:
        """Per-bus EENS MWh/yr (nsqMain.m:345-358), the exact enumerated
        part included."""
        mean = self.sum_nodal / max(self.n, 1.0)
        if self.mu_nodal is not None:
            mean = mean + self.mu_nodal
        return mean * hours_per_year

    def component_importance(self) -> np.ndarray:
        """P(component down | system failure) (nsqMain.m:360-376), from
        the raw failure count: a ratio of means, each the MC mean plus its
        exact enumerated part (the ratio of counts without one)."""
        if self.sum_comp_fail is None:
            return np.zeros(0)
        n = max(self.n, 1.0)
        num = self.sum_comp_fail / n
        if self.mu_comp_fail is not None:
            num = num + self.mu_comp_fail
        den = (self.sum_flag_raw or self.sum_flag) / n + self.mu_flag_raw
        if den == 0:
            return np.zeros(0)
        return num / den

    def state(self) -> dict:
        """The fields as a dict, for a checkpoint."""
        return dataclasses.asdict(self)

    @classmethod
    def from_state(cls, d: dict) -> "RunningStats":
        """Inverse of :meth:`state`. A JSON round trip may turn the array
        fields into lists; they come back as float64 arrays, so the index
        properties work even when a restored study stops before folding
        another batch."""
        d = dict(d)
        for k in ("sum_nodal", "sum_comp_fail", "mu_nodal", "mu_comp_fail"):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k], np.float64)
        return cls(**d)


@dataclasses.dataclass
class AnnualStats:
    """Host-side per-year accumulator (SEQ path, seqMain.m:160-198);
    mirrors reference ``parallel/accumulators.py::AnnualStats``."""

    ens: list = dataclasses.field(default_factory=list)    # MWh per year
    plc: list = dataclasses.field(default_factory=list)
    nlc: list = dataclasses.field(default_factory=list)
    dlc: list = dataclasses.field(default_factory=list)
    dns: list = dataclasses.field(default_factory=list)
    sum_nodal: np.ndarray | None = None
    sum_comp_fail: np.ndarray | None = None
    total_loss_hours: float = 0.0

    def update_years(self, ens, plc, nlc, dlc, dns, nodal_sum,
                     comp_fail_sum, loss_hours) -> None:
        """Append one batch's per-year indices and add its sums."""
        for lst, v in ((self.ens, ens), (self.plc, plc), (self.nlc, nlc),
                       (self.dlc, dlc), (self.dns, dns)):
            lst.extend(_f64(v).reshape(-1).tolist())
        nodal_sum, comp_fail_sum = _f64(nodal_sum), _f64(comp_fail_sum)
        self.sum_nodal = (nodal_sum if self.sum_nodal is None
                          else self.sum_nodal + nodal_sum)
        self.sum_comp_fail = (comp_fail_sum if self.sum_comp_fail is None
                              else self.sum_comp_fail + comp_fail_sum)
        self.total_loss_hours += float(loss_hours)

    @property
    def years(self) -> int:
        return len(self.ens)

    @property
    def eens(self) -> float:
        return float(np.mean(self.ens)) if self.ens else 0.0

    @property
    def cov(self) -> float:
        """std / (mean sqrt(N)) with ddof = 1 (seqMain.m:183-185); inf
        below two years, at a zero mean, or at zero observed spread (a
        positive mean with no spread cannot show convergence)."""
        n = self.years
        if n < 2 or self.eens <= 0:
            return float("inf")
        s = np.std(self.ens, ddof=1)
        if s == 0.0:
            return float("inf")
        return float(s / (self.eens * np.sqrt(n)))

    def nodal_eens(self) -> np.ndarray:
        """Per-bus EENS, MWh/yr (seqMain.m:252-257)."""
        return self.sum_nodal / max(self.years, 1)

    def component_importance(self) -> np.ndarray:
        """Share of loss hours each component was down in."""
        if self.sum_comp_fail is None or self.total_loss_hours == 0:
            return np.zeros(0)
        return self.sum_comp_fail / self.total_loss_hours

    def state(self) -> dict:
        """The fields as a dict, for a checkpoint."""
        return dataclasses.asdict(self)

    @classmethod
    def from_state(cls, d: dict) -> "AnnualStats":
        """Inverse of :meth:`state` (array fields may arrive as lists)."""
        d = dict(d)
        for k in ("sum_nodal", "sum_comp_fail"):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k], np.float64)
        return cls(**d)
