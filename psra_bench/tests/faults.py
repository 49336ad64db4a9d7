"""Faults planted under the timed path, for the tests that see
``correct`` come out false. Each takes pytest's ``monkeypatch`` and
breaks the program where the fault would arise; the benchmark's tap then
wraps the broken evaluator as it wraps the sound one."""
from __future__ import annotations

from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.parallel import accumulators


def _wrap_evaluator(monkeypatch, change):
    orig = dcopf.evaluate_states_screened

    def screened(*args, **kwargs):
        res, n_over = orig(*args, **kwargs)
        return change(res), n_over
    monkeypatch.setattr(dcopf, "evaluate_states_screened", screened)


def altered_answer(monkeypatch):
    """One state's loss of load 50 MW off where the evaluator makes it."""
    def change(res):
        dns = res.dns_mw.clone()
        dns[dns.shape[0] // 3] += 50.0
        return res._replace(dns_mw=dns, failure=dns > 1e-4)
    _wrap_evaluator(monkeypatch, change)


def lost_flag(monkeypatch):
    """The failure flag of every state shedding more than 10 MW dropped
    where the evaluator sets it; the losses of load are left as they are."""
    def change(res):
        return res._replace(failure=res.failure & (res.dns_mw <= 10.0))
    _wrap_evaluator(monkeypatch, change)


def half_batch(monkeypatch):
    """The second half of every batch left out: its answers are the first
    half's, so the batch's mean is the first half's."""
    def change(res):
        h = res.dns_mw.shape[0] // 2
        out = []
        for t in (res.dns_mw, res.nodal_mw, res.failure):
            t = t.clone()
            t[h:2 * h] = t[:h]
            out.append(t)
        return res._replace(dns_mw=out[0], nodal_mw=out[1],
                            failure=out[2])
    _wrap_evaluator(monkeypatch, change)


def stale_statistics(monkeypatch):
    """The study's statistics left unchanged by every batch."""
    monkeypatch.setattr(accumulators.RunningStats, "update",
                        lambda self, m: None)
    monkeypatch.setattr(accumulators.AnnualStats, "update_years",
                        lambda self, *a: None)


FAULTS = {"altered_answer": altered_answer, "half_batch": half_batch,
          "stale_statistics": stale_statistics}
