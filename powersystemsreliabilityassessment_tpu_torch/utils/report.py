"""Reporting: CSV / JSON / .mat export in the reference's schemas, and
the study figures.

Port of ``powersystemsreliabilityassessment_tpu/utils/report.py``:

* ``nodal_results.csv``: ``BusID,EENS_MWh_yr`` (nsqMain.m:395-400 /
  seqMain.m:252-257);
* the result's ``to_dict()`` as JSON and as a MATLAB ``.mat``
  (nsqMain.m:404-405, seqMain.m:261-262 save ``.mat`` files);
* the eight matplotlib figures: NSQ convergence and nodal / weak points,
  SEQ, tail risk, the HL1 three-engine comparison, COPT adequacy, and
  the Markov and parameter-estimation teaching figures.

matplotlib is imported inside :func:`_plt`, at the first figure, so a
machine without it runs every study and export. Everything here runs on
the host on numpy arrays.
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


def _plt():
    """matplotlib.pyplot on the Agg backend, imported here (not when this
    module is imported: a machine without matplotlib runs every study and
    export). Mirrors reference ``utils/report.py::_plt``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_nsq(result, out_path: str, beta_limit: float = 0.0017) -> None:
    """NSQ four-panel convergence figure (beta, EDNS, LOLE, PLC by batch;
    nsqMain.m:410-440). Mirrors reference ``plot_nsq``."""
    plt = _plt()
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    axes[0, 0].plot(result.beta_history)
    axes[0, 0].axhline(beta_limit, color="r", ls="--")
    axes[0, 0].set_title("Convergence of beta")
    axes[0, 1].plot(result.edns_history, color="g")
    axes[0, 1].set_title("EDNS (MW)")
    axes[1, 0].plot(result.lole_history, color="m")
    axes[1, 0].set_title("LOLE (hr/yr)")
    axes[1, 1].plot(result.plc_history, color="c")
    axes[1, 1].set_title("Prob. Load Curtailment")
    for ax in axes.flat:
        ax.grid(True)
        ax.set_xlabel("batch")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_nodal_and_weakpoints(nodal_eens: np.ndarray,
                              comp_importance: np.ndarray, n_gen: int,
                              out_path: str, top_k: int = 15) -> None:
    """Nodal EENS bars and the ``top_k`` critical components
    (nsqMain.m:443-469). Mirrors reference ``plot_nodal_and_weakpoints``."""
    plt = _plt()
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(12, 5))
    a1.bar(np.arange(1, len(nodal_eens) + 1), nodal_eens,
           color="#3399cc")
    a1.set_xlabel("Bus ID"); a1.set_ylabel("EENS (MWh/yr)")
    a1.set_title("Nodal Reliability (EENS)"); a1.grid(True)
    if len(comp_importance):
        order = np.argsort(-comp_importance)[:top_k]
        a2.bar(range(len(order)), comp_importance[order] * 100,
               color="#cc4c4c")
        a2.set_xticks(range(len(order)))
        a2.set_xticklabels(
            ["G%d" % (i + 1) if i < n_gen else "L%d" % (i - n_gen + 1)
             for i in order], rotation=45)
        a2.set_ylabel("Probability (%)")
        a2.set_title(f"Top {len(order)} Critical Components")
        a2.grid(True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_seq(result, out_path: str, cov_threshold: float = 0.05,
             n_gen: int = 33) -> None:
    """SEQ six-panel figure: EENS and CoV convergence, the annual-ENS
    histogram, nodal EENS, critical components (seqMain.m:267-314).
    Mirrors reference ``plot_seq``."""
    plt = _plt()
    fig, axes = plt.subplots(2, 3, figsize=(14, 7))
    axes[0, 0].plot(result.eens_history, "b-")
    axes[0, 0].set_title("Convergence of EENS (MWh/yr)")
    axes[0, 1].plot(result.cov_history, "r-")
    axes[0, 1].axhline(cov_threshold, color="k", ls="--")
    axes[0, 1].set_title("Convergence of CoV")
    annual = getattr(result, "annual_ens", None) or result.eens_history[-1:]
    axes[0, 2].hist(np.asarray(annual), bins=20, color="0.4")
    axes[0, 2].set_title("Distribution of Annual EENS")
    axes[1, 0].bar(np.arange(1, len(result.nodal_eens_mwh_yr) + 1),
                   result.nodal_eens_mwh_yr, color="#3399cc")
    axes[1, 0].set_title("Nodal Reliability")
    imp = result.comp_importance
    if len(imp):
        order = np.argsort(-imp)[:15]
        ax = axes[1, 1]
        ax.bar(range(len(order)), imp[order] * 100, color="#cc4c4c")
        ax.set_xticks(range(len(order)))
        ax.set_xticklabels(
            ["G%d" % (i + 1) if i < n_gen else "L%d" % (i - n_gen + 1)
             for i in order], rotation=45)
        ax.set_title("Top Critical Components (%)")
    axes[1, 2].axis("off")
    for ax in axes.flat:
        ax.grid(True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_tail_risk(cmp_result, out_path: str) -> None:
    """Annual-LOLE histogram, the peak window's hourly risk and the
    cumulative risk, Monte Carlo against analytical (tail_risk.jl:146-204).
    Mirrors reference ``plot_tail_risk``."""
    plt = _plt()
    fig, (a1, a2, a3) = plt.subplots(1, 3, figsize=(15, 4.5))
    a1.hist(cmp_result.mc_yearly_distribution, bins=50, density=True,
            alpha=0.6, color="b", label="MC yearly outcomes")
    a1.axvline(cmp_result.analytical_lole, color="r", lw=3,
               label="Analytical prediction")
    a1.axvline(cmp_result.mc_lole, color="b", ls="--", lw=2,
               label="MC average")
    a1.axvline(cmp_result.var95, color="k", ls=":", label="VaR95")
    a1.set_title("Distribution of annual risk (tail risk)")
    a1.set_xlabel("LOLE (h/yr)"); a1.legend()
    peak = int(np.argmax(cmp_result.mc_hourly_profile))
    lo, hi = max(0, peak - 50), peak + 50
    a2.fill_between(range(lo, hi), cmp_result.mc_hourly_profile[lo:hi],
                    alpha=0.3, color="b")
    a2.plot(range(lo, hi), cmp_result.analytical_hourly_profile[lo:hi],
            "r", lw=2)
    a2.set_title("Hourly risk profile (peak window)")
    a3.plot(np.cumsum(cmp_result.mc_hourly_profile), "b", label="MC")
    a3.plot(np.cumsum(cmp_result.analytical_hourly_profile), "r--",
            label="Analytical")
    a3.set_title("Cumulative risk over year"); a3.legend()
    for ax in (a1, a2, a3):
        ax.grid(True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_hl1_comparison(results, out_path: str) -> None:
    """Three-engine comparison figure (PowerSystemAdequacy.jl:275-298):
    MC convergence histories against the analytical LOLE line, plus the
    LOLE/EUE method bars.
    Mirrors reference ``plot_hl1_comparison``."""
    plt = _plt()
    fig, (a1, a2, a3) = plt.subplots(1, 3, figsize=(14, 4.5))
    ana = next((r for r in results if r.method.startswith("Analytical")),
               None)
    for r in results:
        if r.convergence_history:
            a1.plot(np.arange(1, len(r.convergence_history) + 1),
                    r.convergence_history, label=r.method)
    if ana is not None:
        a1.axhline(ana.lole_hours_yr, color="r", ls="--",
                   label="Analytical")
    a1.set_xlabel("batch"); a1.set_ylabel("LOLE (h/yr)")
    a1.set_title("MC convergence vs analytical"); a1.legend()
    names = [r.method for r in results]
    a2.bar(names, [r.lole_hours_yr for r in results], color="#3399cc")
    a2.set_ylabel("LOLE (h/yr)"); a2.set_title("LOLE by method")
    a2.tick_params(axis="x", rotation=20)
    a3.bar(names, [r.eue_mwh_yr for r in results], color="#cc8833")
    a3.set_ylabel("EUE (MWh/yr)"); a3.set_title("EUE by method")
    a3.tick_params(axis="x", rotation=20)
    for ax in (a1, a2, a3):
        ax.grid(True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_copt_adequacy(probs: np.ndarray, step: float,
                       total_capacity: float, hourly_load: np.ndarray,
                       out_path: str) -> None:
    """COPT + adequacy figure (generating_adequacy_assessment.jl:277-306):
    individual and cumulative outage probabilities on the MW grid, the
    load-duration curve, and the hourly LOLP profile.
    Mirrors reference ``plot_copt_adequacy``."""
    plt = _plt()
    probs = np.asarray(probs, np.float64)
    x = np.arange(len(probs)) * step
    cum = np.cumsum(probs[::-1])[::-1]          # P[Outage >= x]
    fig, axes = plt.subplots(2, 2, figsize=(12, 7))
    axes[0, 0].bar(x, probs, width=0.8 * step, color="#3399cc")
    axes[0, 0].set_yscale("log")
    axes[0, 0].set_xlabel("Capacity on outage (MW)")
    axes[0, 0].set_title("COPT: individual probability")
    axes[0, 1].semilogy(x, np.maximum(cum, 1e-300), color="#cc4c4c")
    axes[0, 1].set_xlabel("Capacity on outage (MW)")
    axes[0, 1].set_title("COPT: cumulative P[Outage >= x]")
    load = np.asarray(hourly_load, np.float64)
    axes[1, 0].plot(np.sort(load)[::-1], color="0.3")
    axes[1, 0].set_xlabel("hours (sorted)"); axes[1, 0].set_ylabel("MW")
    axes[1, 0].set_title("Load-duration curve")
    reserve = total_capacity - load
    idx = np.clip(np.floor(reserve / step).astype(int) + 1, 0,
                  len(cum) - 1)
    lolp_h = cum[idx]
    axes[1, 1].semilogy(np.maximum(lolp_h, 1e-300), color="#338833")
    axes[1, 1].set_xlabel("hour"); axes[1, 1].set_title("Hourly LOLP")
    for ax in axes.flat:
        ax.grid(True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_markov_education(times: np.ndarray, t_theory: np.ndarray,
                          pdf_theory: np.ndarray, single,
                          cap_series: np.ndarray, total_cap: float,
                          out_path: str) -> None:
    """Markov teaching figure (Markov_process.jl:46-74, :100-142,
    :149-207): simulated-TTF histogram vs the exponential PDF, analytical
    pi(t) evolution vs one MC realization vs steady state, and the 5-unit
    available-capacity series.
    Mirrors reference ``plot_markov_education``."""
    plt = _plt()
    fig, (a1, a2, a3) = plt.subplots(1, 3, figsize=(15, 4.5))
    a1.hist(times, bins=50, density=True, alpha=0.6, color="b",
            label="simulated TTF")
    a1.plot(t_theory, pdf_theory, "r", lw=2, label="exponential PDF")
    a1.set_xlabel("time to failure (h)")
    a1.set_title("Constant hazard => exponential TTF"); a1.legend()
    a2.plot(single.prob_down_analytical, "b", lw=2,
            label="analytical P(down, t)")
    a2.step(np.arange(len(single.mc_realization)), single.mc_realization,
            "g", alpha=0.5, label="one MC realization")
    a2.axhline(single.steady_state, color="r", ls="--",
               label="steady state U")
    a2.set_xlabel("hour"); a2.set_title("pi(t+1) = pi(t) P vs MC")
    a2.legend()
    a3.plot(cap_series, color="0.3")
    a3.axhline(total_cap, color="r", ls="--", label="installed")
    a3.set_xlabel("hour"); a3.set_ylabel("MW")
    a3.set_title("Available capacity (5 units)"); a3.legend()
    for ax in (a1, a2, a3):
        ax.grid(True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_parameter_estimation(est, out_path: str) -> None:
    """Running lambda-hat convergence (parameter_estimation.jl:102-113).
    Mirrors reference ``plot_parameter_estimation``."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(np.arange(1, len(est.running_lambda) + 1), est.running_lambda,
            "b", label="lambda-hat = N / sum(TTF)")
    ax.axhline(est.true_lambda, color="r", ls="--", label="true lambda")
    ax.set_xlabel("observed failures"); ax.set_ylabel("1/h")
    ax.set_title("Failure-rate estimation from field logs")
    ax.legend(); ax.grid(True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


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
    reference ``utils/report.py::export_study``, which writes no figure
    itself (``make_plots`` and ``plot_kw`` are accepted and unused there
    too); the CLI draws the figures with the ``plot_*`` functions."""
    os.makedirs(out_dir, exist_ok=True)
    export_nodal_csv(os.path.join(out_dir, f"{prefix}_nodal_results.csv"),
                     result.nodal_eens_mwh_yr)
    export_json(os.path.join(out_dir, f"{prefix}_results.json"),
                result.to_dict())
    export_mat(os.path.join(out_dir, f"{prefix}_reliability_results.mat"),
               result.to_dict())
