"""Exact low-order contingency enumeration (state-space truncation).

Port of ``powersystemsreliabilityassessment_tpu/sampling/enumeration.py``.
The NSQ expectation over i.i.d. Bernoulli component states S splits as

    E[f(S)] = sum_{|S| <= k} p(S) f(S)      <- enumerated exactly
            + E[f(S) 1(|S| > k)]            <- deep tail, by Monte Carlo

Every outage combination up to order ``k`` is evaluated once through the
same screened DC-OPF evaluator the Monte Carlo uses, in fixed-shape
chunks on the device, and weighted by its exact float64 probability on
the host. The enumerated mass carries no sampling variance, so the
study's Monte Carlo (``studies/hl2_nsq.py``, ``enum_order``) estimates
only the tail; the exact part also bounds the full index: index in
[exact, exact + P(|S| > k) worst case].

The state law is ``sampling/state.py``'s: components pinned up
(``always_up_nsq``) or with U = 0 never fail, so they are left out of the
enumeration and contribute probability factor 1.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from math import comb

import numpy as np
import torch


@dataclasses.dataclass
class ExactPart:
    """Float64 exact contributions of all states with <= ``order``
    outages; mirrors reference ``sampling/enumeration.py::ExactPart``."""

    order: int
    n_states: int            # enumerated states (the all-up state included)
    mass: float              # P(#down <= order)
    edns_mw: float           # E[DNS 1(#down <= order)]
    pfail: float             # E[fail 1(#down <= order)]
    nodal_mw: np.ndarray     # [nb] E[nodal shed 1(...)]
    comp_fail: np.ndarray    # [n_comp] E[comp down and fail 1(...)]
    infeasible: int          # enumerated states with no feasible dispatch
    # Certified truncation bounds on the full index: edns in [edns_mw,
    # edns_mw + (1 - mass) total_load], pfail in [pfail, pfail + (1 - mass)].
    tail_mass: float


def free_components(unavail: np.ndarray, always_up: np.ndarray) -> np.ndarray:
    """Indices of the components that can fail under the NSQ law. Mirrors
    reference ``sampling/enumeration.py::free_components``."""
    p = np.where(always_up, 0.0, np.asarray(unavail, np.float64))
    return np.nonzero(p > 0.0)[0].astype(np.int32)


def count_states(n_free: int, order: int) -> int:
    """States with at most ``order`` of ``n_free`` components down."""
    return sum(comb(n_free, j) for j in range(order + 1))


@lru_cache(maxsize=64)
def _binom_table(n: int, j: int) -> np.ndarray:
    """[n + 1] int64 table of C(c, j) for c = 0..n (nondecreasing in c)."""
    t = np.zeros(n + 1, np.int64)
    for c in range(j, n + 1):
        t[c] = comb(c, j)          # exact; C(888, 5) ~ 4.5e12 << 2^63
    return t


def unrank_combinations(ranks: np.ndarray, j: int, n: int) -> np.ndarray:
    """Colexicographic unranking (the combinatorial number system),
    vectorized: rank r in [0, C(n, j)) maps to the j-subset {c_1 < ... <
    c_j} of range(n) with r = sum_i C(c_i, i), one ``searchsorted`` over a
    binomial table a digit. Mirrors reference
    ``sampling/enumeration.py::unrank_combinations``."""
    r = np.ascontiguousarray(ranks, np.int64).copy()
    out = np.empty((r.size, j), np.int32)
    for i in range(j, 0, -1):
        table = _binom_table(n, i)
        c = np.searchsorted(table, r, side="right") - 1
        out[:, i - 1] = c
        r -= table[c]
    return out


def _combo_chunks(n_free: int, order: int, chunk: int):
    """Yield (j, combos int32 [c, j]) over every combination of each order
    j = 1..order, at most ``chunk`` rows at a time (colex order, indices
    ascending within a row)."""
    for j in range(1, order + 1):
        total = comb(n_free, j)
        for start in range(0, total, chunk):
            ranks = np.arange(start, min(start + chunk, total),
                              dtype=np.int64)
            yield j, unrank_combinations(ranks, j, n_free)


def state_log_weights(combos: np.ndarray, logit: np.ndarray,
                      log_base: float) -> np.ndarray:
    """log p(S) of combination rows over free-component indices (float64).
    Mirrors reference ``sampling/enumeration.py::state_log_weights``."""
    return log_base + np.sum(logit[combos], axis=1)


def make_chunk_step(sys, compat, ipm, nodal_mode: str, chunk: int,
                    max_lp: int):
    """``down [chunk, n_comp] -> packed float32 [4 + nb, chunk]``: the
    screened evaluation of one chunk (rows: DNS, failure, infeasible, the
    overflow count, then the nodal shed), so that the host reads the
    whole chunk, the count included, in one copy."""
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    load = sys.load_pd[None, :].expand(chunk, sys.n_load)

    def step(down: torch.Tensor) -> torch.Tensor:
        res, n_over = dcopf.evaluate_states_screened(
            sys, down, load, max_lp, compat, ipm, nodal_mode)
        dt = res.dns_mw.dtype
        over = n_over.to(dt).expand(chunk)
        return torch.cat([torch.stack([
            res.dns_mw, res.failure.to(dt), res.infeasible.to(dt), over]),
            res.nodal_mw.T])

    return step


def enumerate_exact(sys, compat, ipm, nodal_mode: str, order: int,
                    chunk: int = 65536, max_lp: int | None = None,
                    log_every: int = 0) -> ExactPart:
    """Evaluate every state with <= ``order`` outages exactly and fold the
    results in float64 on the host; mirrors reference
    ``sampling/enumeration.py::enumerate_exact``.

    ``sys`` is the built System; the chunks run on its device through
    ``dcopf.evaluate_states_screened`` at a fixed shape [``chunk``,
    n_comp] (a short chunk padded with all-up rows that are dropped).
    ``max_lp`` (None: chunk / 16, at least 16) is the LP buffer; a chunk
    whose LP need overflows it is redone at twice the buffer, kept for
    later chunks, so no lane is left at its bound. The host reads one
    packed copy of each chunk's results, its overflow count included.
    The all-up state is evaluated, not assumed shed-free.
    """
    unavail = sys.unavail.detach().cpu().numpy().astype(np.float64)
    always_up = sys.always_up_nsq.detach().cpu().numpy().astype(bool)
    free = free_components(unavail, always_up)
    n_comp, nb = unavail.shape[0], sys.n_bus
    p = unavail[free]
    logit = np.log(p) - np.log1p(-p)                 # per-comp down logit
    log_base = float(np.sum(np.log1p(-p)))           # all-up log-prob
    if max_lp is None:
        max_lp = max(chunk // 16, 16)
    step = make_chunk_step(sys, compat, ipm, nodal_mode, chunk, max_lp)
    free_d = torch.as_tensor(free.astype(np.int64), device=sys.device)

    edns = pfail = mass = 0.0
    nodal = np.zeros(nb, np.float64)
    comp_fail = np.zeros(n_comp, np.float64)
    n_states = n_infeasible = done = 0

    def chunks():
        yield 0, np.zeros((1, 0), np.int32)
        yield from _combo_chunks(len(free), order, chunk)

    for j, combos in chunks():
        w = np.exp(state_log_weights(combos, logit, log_base))
        c = combos.shape[0]
        down = torch.zeros((chunk, n_comp), dtype=torch.bool,
                           device=sys.device)
        if j:
            cols = free_d[torch.as_tensor(combos.astype(np.int64),
                                          device=sys.device)]
            down[:c].scatter_(1, cols, True)
        while True:
            v = step(down).cpu().numpy().astype(np.float64)
            n_over = int(v[3, 0])
            if n_over == 0:
                break
            max_lp *= 2
            if max_lp > chunk:
                raise RuntimeError("enumeration LP buffer exceeded chunk")
            if log_every:
                print(f"enum: LP buffer overflow ({n_over}); growing to "
                      f"{max_lp}")
            step = make_chunk_step(sys, compat, ipm, nodal_mode, chunk,
                                   max_lp)
        dns, fail, infeas = v[0, :c], v[1, :c], v[2, :c]
        edns += float(w @ dns)
        pfail += float(w @ fail)
        nodal += v[4:, :c] @ w
        comp_fail += np.bincount(free[combos].ravel(),
                                 weights=np.repeat(w * fail, j),
                                 minlength=n_comp)
        mass += float(np.sum(w))
        n_states += c
        n_infeasible += int(np.sum(infeas > 0))
        done += c
        if log_every and done % (log_every * chunk) < chunk:
            print(f"enum: {done:,} states, exact EDNS so far {edns:.4f}")

    return ExactPart(order=order, n_states=n_states, mass=mass,
                     edns_mw=edns, pfail=pfail, nodal_mw=nodal,
                     comp_fail=comp_fail, infeasible=n_infeasible,
                     tail_mass=max(1.0 - mass, 0.0))
