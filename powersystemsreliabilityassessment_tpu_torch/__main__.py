"""Command-line interface: ``python -m powersystemsreliabilityassessment_tpu_torch``.

Port of ``powersystemsreliabilityassessment_tpu/__main__.py``: the same
subcommands, flags, defaults and choices, the same JSON lines, exports
and figures, with each study run by the port on the card:

  nsq         HL2 non-sequential MCS (nsqMain path)
  seq         HL2 sequential chronological MCS (seqMain path), with
              --split-level the multilevel-splitting study
  hl1         HL1 three-engine comparison (run_full_comparison path)
  education   Markov-process / parameter-estimation / COPT figures
  planning    analytical planning + ELU comparison + tail risk
  multiarea   ISOLATED vs INTERCONNECTED multi-area comparison
  scaleup     the NSQ study on a larger case, antithetic by default
  bench       the port's benchmark (not written yet)

Deliberate differences (ROADMAP.md Queue 3):

* ``--device`` (default ``cuda``) on every study, passed to each entry
  point; ``--device cpu`` runs the study on the CPU.
* ``--checkpoint-backend orbax`` parses, then fails: the port keeps JSON
  checkpoints.
* ``bench`` fails: the port's benchmark does not exist yet, and
  ``bench.py`` times the JAX package.
* Where matplotlib cannot be imported, the exports and the JSON line are
  still written, one stderr line names the figures that were not, and
  the exit code stays 0.
* ``--early-exit`` is accepted and changes nothing: the port's K1 already
  stops each frozen lane on its own.

Several devices: ``nsq``, ``seq`` (and ``--split-level``), ``hl1``,
``multiarea`` and ``scaleup`` run on a scenario mesh of one process per
device (``parallel/mesh.py``) when started by torchrun::

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m powersystemsreliabilityassessment_tpu_torch nsq ...

Each rank then runs on ``cuda:LOCAL_RANK`` (``--device cuda``; ``--device
cpu`` runs the ranks on the CPU over gloo), every rank draws its own
share of each batch, one ``all_reduce`` a step sums the partials, and
rank 0 alone prints the JSON line and writes the exports and figures.
The process group is NCCL on cards and gloo on the CPU;
``PSRA_MESH_BACKEND=gloo`` with an explicit ``--device cuda:0`` lets
ranks share one card. ``education`` and ``planning`` do not shard and
refuse to run under torchrun. Without torchrun nothing changes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# The studies that shard their scenarios over a torchrun mesh.
MESH_STUDIES = ("nsq", "seq", "hl1", "multiarea", "scaleup")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device the study runs on (default: the "
                        "card; 'cpu' runs it on the CPU)")


def build_parser() -> argparse.ArgumentParser:
    """CLI parser, separate from dispatch so tests can parse flag
    combinations without running a study. Mirrors reference
    ``__main__.py::build_parser``, plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="powersystemsreliabilityassessment_tpu_torch")
    sub = p.add_subparsers(dest="study", required=True)

    nsq = sub.add_parser("nsq")
    nsq.add_argument("--case", default="rts24",
                     help="builtin case name or MATPOWER .m path")
    nsq.add_argument("--samples", type=int, default=100_000)
    nsq.add_argument("--batch", type=int, default=8192)
    nsq.add_argument("--beta", type=float, default=0.0017)
    nsq.add_argument("--seed", type=int, default=0)
    nsq.add_argument("--out", default="results")
    nsq.add_argument("--checkpoint", default=None)
    nsq.add_argument("--checkpoint-backend", default="json",
                     choices=["json", "orbax"],
                     help="'orbax' is not ported: the port keeps JSON "
                          "checkpoints")
    nsq.add_argument("--is-boost", type=float, default=0.0,
                     help="importance-sampling failure boost (0 = plain "
                          "MC; try 2-4 for rare-event regimes)")
    nsq.add_argument("--is-boost-scope", default="all",
                     choices=["all", "gens", "branches"],
                     help="components the boost applies to: 'gens' "
                          "leaves branch rates at the true measure, "
                          "preserving the certificate closure rate; "
                          "'branches' targets transmission/islanding-"
                          "driven risk (case300-class systems)")
    nsq.add_argument("--is-ce", action="store_true",
                     help="cross-entropy adaptive importance sampling: "
                          "a pilot phase learns per-component proposal "
                          "rates from the CE-optimal marginals "
                          "E[DNS*1(k down)]/E[DNS] "
                          "(hl2_nsq.calibrate_ce_proposal)")
    nsq.add_argument("--ce-rounds", type=int, default=2)
    nsq.add_argument("--ce-batch", type=int, default=32768)
    nsq.add_argument("--ce-boost0", type=float, default=4.0)
    nsq.add_argument("--control-variate", action="store_true",
                     help="copper-sheet control variate with exact f64 "
                          "COPT mean (composes with --is-boost and "
                          "antithetic; studies/hl2_nsq.py)")
    nsq.add_argument("--early-exit", action="store_true",
                     help="accepted and unused: the port's K1 "
                          "(csrc/ipm_fused.cu) already stops each frozen "
                          "lane on its own")
    nsq.add_argument("--fused-tier1", action="store_true",
                     help="fused sampler + first-pass certificate kernel "
                          "K4 (csrc/fused_sampler_cert.cu) on the card "
                          "(plain MC, RTS-24-class systems; a different "
                          "Philox stream than the default sampler)")
    nsq.add_argument("--enum-order", type=int, default=0,
                     help="contingency-enumeration hybrid: evaluate every "
                          "state with <= K outages exactly (f64-weighted "
                          "pre-pass), MC only the deeper tail "
                          "(sampling/enumeration.py; try 3-5)")
    _add_device(nsq)

    seq = sub.add_parser("seq")
    seq.add_argument("--case", default="rts24",
                     help="builtin case name or MATPOWER .m path")
    seq.add_argument("--years", type=int, default=4000)
    seq.add_argument("--cov", type=float, default=0.05)
    seq.add_argument("--seed", type=int, default=0)
    seq.add_argument("--out", default="results")
    seq.add_argument("--checkpoint", default=None)
    seq.add_argument("--checkpoint-backend", default="json",
                     choices=["json", "orbax"],
                     help="'orbax' is not ported: the port keeps JSON "
                          "checkpoints")
    seq.add_argument("--years-per-device", type=int, default=16,
                     help="simulated years per batch step")
    seq.add_argument("--split-level", default=None,
                     help="enable multilevel splitting (RESTART): copper "
                          "margin level in MW that triggers cloning, or "
                          "'auto' to calibrate from a sampler-only pilot "
                          "(rare-event variance reduction; see "
                          "studies/hl2_seq_split.py)")
    seq.add_argument("--split-k", type=int, default=4,
                     help="tail samples per split parent (incl. parent)")
    seq.add_argument("--control-variate", action="store_true",
                     help="copper-sheet control variate with exact f64 "
                          "COPT mean (implies --sampling stationary; "
                          "studies/hl2_seq.py)")
    seq.add_argument("--sampling", default="reference",
                     choices=("reference", "stationary"),
                     help="'stationary' starts each year from the "
                          "stationary component distribution "
                          "(continuous dwells, no January transient)")
    seq.add_argument("--split-max", type=int, default=8,
                     help="max split parents per batch")
    seq.add_argument("--early-exit", action="store_true",
                     help="accepted and unused: the port's K1 "
                          "(csrc/ipm_fused.cu) already stops each frozen "
                          "lane on its own")
    seq.add_argument("--maintenance", action="store_true",
                     help="apply the levelized maintenance schedule "
                          "derived from the genweeks data (reference "
                          "case24_failrate.m col 4; incompatible with "
                          "--control-variate and --split-level)")
    _add_device(seq)

    hl1 = sub.add_parser("hl1")
    hl1.add_argument("--iterations", type=int, default=5000)
    hl1.add_argument("--years", type=int, default=500)
    hl1.add_argument("--out", default="results")
    _add_device(hl1)

    edu = sub.add_parser(
        "education",
        help="Markov-process / parameter-estimation / COPT teaching "
             "figures (Markov_process.jl, parameter_estimation.jl, "
             "generating_adequacy_assessment.jl)")
    edu.add_argument("--out", default="results")
    _add_device(edu)

    pl = sub.add_parser("planning")
    pl.add_argument("--mc-years", type=int, default=1000)
    pl.add_argument("--hydro-hours", type=float, default=600.0)
    _add_device(pl)

    ma = sub.add_parser("multiarea")
    ma.add_argument("--years", type=int, default=100)
    ma.add_argument("--system", default="demo",
                    choices=["demo", "rts96", "ring", "case"],
                    help="demo: reference 2-area; rts96: 3 areas from the "
                         "network case; ring: N-area tiled ring; case: "
                         "areas from --case's BUS_AREA column")
    ma.add_argument("--areas", type=int, default=4,
                    help="ring size (--system ring)")
    ma.add_argument("--case", default="rts96",
                    help="builtin case name or MATPOWER .m path "
                         "(--system case)")
    _add_device(ma)

    sc = sub.add_parser("scaleup")
    sc.add_argument("--case", default="rts96")
    sc.add_argument("--samples", type=int, default=50_000)
    sc.add_argument("--antithetic", action="store_true", default=True)
    _add_device(sc)

    sub.add_parser("bench")

    return p


def _have_matplotlib() -> bool:
    from powersystemsreliabilityassessment_tpu_torch.utils import report
    try:
        report._plt()
    except ImportError:
        return False
    return True


def _figures_missing(paths) -> None:
    print("matplotlib is not installed; figures not written: "
          + ", ".join(paths), file=sys.stderr)


def _figures(writers) -> None:
    """Write each ``(path, write)`` figure; where matplotlib cannot be
    imported, one stderr line names them instead. Nothing else is
    caught."""
    if not _have_matplotlib():
        _figures_missing([path for path, _ in writers])
        return
    for path, write in writers:
        write(path)


def _checkpointer(p: argparse.ArgumentParser, args):
    from powersystemsreliabilityassessment_tpu_torch.runtime.checkpoint import (
        Checkpointer)
    if args.checkpoint_backend == "orbax":
        p.error("--checkpoint-backend orbax is not ported: the port keeps "
                "JSON checkpoints (ROADMAP.md, 'Do not port'); use json")
    return Checkpointer(args.checkpoint) if args.checkpoint else None


def main(argv=None) -> None:
    """Parse ``argv`` (None: ``sys.argv``) and run the study. Mirrors
    reference ``__main__.py::main``. Under torchrun (``WORLD_SIZE`` above
    1) the process group is initialised, the study runs on the scenario
    mesh, and the group it initialised is destroyed at the end."""
    p = build_parser()
    args = p.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        _run(p, args, None)
        return
    if args.study not in MESH_STUDIES:
        p.error(f"{args.study} does not run on a mesh; start it without "
                "torchrun")
    import torch.distributed as dist

    from powersystemsreliabilityassessment_tpu_torch.parallel import (
        mesh as meshlib)
    backend = os.environ.get("PSRA_MESH_BACKEND") or None
    started = meshlib.init_from_env(args.device, backend)
    try:
        _run(p, args, meshlib.scenario_mesh(args.device, backend))
    finally:
        if started:
            dist.destroy_process_group()


def _run(p: argparse.ArgumentParser, args, mesh) -> None:
    """Run ``args.study``, on ``mesh`` where one is given (then rank 0
    alone prints the result and writes the exports and figures)."""
    lead = mesh is None or mesh.rank == 0
    if args.study == "nsq":
        from powersystemsreliabilityassessment_tpu_torch.core.matpower_io import (
            resolve_case)
        from powersystemsreliabilityassessment_tpu_torch.studies.hl2_nsq import (
            run_nsq_study)
        from powersystemsreliabilityassessment_tpu_torch.utils import report
        from powersystemsreliabilityassessment_tpu_torch.utils.config import (
            MCSConfig)
        ck = _checkpointer(p, args)
        case = resolve_case(args.case)
        res = run_nsq_study(case, MCSConfig(
            batch_size=args.batch, max_samples=args.samples,
            beta_limit=args.beta, seed=args.seed,
            is_boost=args.is_boost,
            is_boost_scope=args.is_boost_scope,
            is_ce=args.is_ce, ce_rounds=args.ce_rounds,
            ce_batch=args.ce_batch, ce_boost0=args.ce_boost0,
            fused_tier1=args.fused_tier1), device=args.device,
            checkpointer=ck, control_variate=args.control_variate,
            enum_order=args.enum_order, mesh=mesh)
        if not lead:
            return
        report.export_study(res, args.out, "nsq")
        _figures([
            (f"{args.out}/convergence.png",
             lambda f: report.plot_nsq(res, f, args.beta)),
            (f"{args.out}/nodal_reliability.png",
             lambda f: report.plot_nodal_and_weakpoints(
                 res.nodal_eens_mwh_yr, res.comp_importance, case.n_gen,
                 f))])
        print(json.dumps({"edns": res.edns_mw, "lole": res.lole_hr_yr,
                          "plc": res.plc, "beta": res.beta}))
    elif args.study == "seq":
        from powersystemsreliabilityassessment_tpu_torch.core.matpower_io import (
            resolve_case)
        from powersystemsreliabilityassessment_tpu_torch.studies.hl2_seq import (
            run_seq_study)
        from powersystemsreliabilityassessment_tpu_torch.utils import report
        from powersystemsreliabilityassessment_tpu_torch.utils.config import (
            MCSConfig)
        if args.split_level is not None:
            if args.control_variate or args.sampling != "reference":
                p.error("--split-level cannot be combined with "
                        "--control-variate/--sampling (the split study "
                        "uses its own continuous-dwell sampler; "
                        "silently ignoring the flags would misreport "
                        "the estimator in use)")
            if args.maintenance:
                p.error("--split-level does not support --maintenance "
                        "(cloning restarts assume time-homogeneous "
                        "component processes)")
        ck = _checkpointer(p, args)
        case = resolve_case(args.case)
        cfg = MCSConfig(max_years=args.years, cov_threshold=args.cov,
                        seed=args.seed)
        if args.split_level is not None:
            from powersystemsreliabilityassessment_tpu_torch.studies.hl2_seq_split import (  # noqa: E501
                SplitConfig, run_seq_split_study)
            res = run_seq_split_study(
                case, cfg,
                SplitConfig(level_mw=(None if args.split_level == "auto"
                                      else float(args.split_level)),
                            k_clones=args.split_k,
                            max_split=args.split_max),
                device=args.device,
                years_per_device=args.years_per_device, checkpointer=ck,
                mesh=mesh)
        else:
            res = run_seq_study(
                case, cfg, device=args.device,
                years_per_device=args.years_per_device, checkpointer=ck,
                sampling=args.sampling,
                control_variate=args.control_variate,
                scheduled_maintenance=args.maintenance, mesh=mesh)
        if not lead:
            return
        report.export_study(res, args.out, "seq")
        _figures([(f"{args.out}/convergence_curve.png",
                   lambda f: report.plot_seq(res, f, args.cov,
                                             case.n_gen))])
        print(json.dumps({"eens": res.eens_mwh_yr, "lole": res.lole_hr_yr,
                          "lolf": res.lolf_occ_yr, "years": res.years}))
    elif args.study == "hl1":
        from powersystemsreliabilityassessment_tpu_torch.studies import (
            hl1_comparison)
        figures = _have_matplotlib()
        hl1_comparison.run_full_comparison(
            args.iterations, args.years,
            out_dir=args.out if figures else None, device=args.device,
            mesh=mesh)
        if not figures and lead:
            _figures_missing([f"{args.out}/hl1_comparison.png"])
    elif args.study == "education":
        import numpy as np

        from powersystemsreliabilityassessment_tpu_torch.engines import copt
        from powersystemsreliabilityassessment_tpu_torch.studies import (
            hl1_comparison, markov_education)
        from powersystemsreliabilityassessment_tpu_torch.utils import report
        os.makedirs(args.out, exist_ok=True)
        times, tt, pdf = markov_education.exponential_proof()
        single = markov_education.single_component_study(device=args.device)
        cap, total = markov_education.multi_unit_capacity_series(
            device=args.device)
        est = markov_education.parameter_estimation_study()
        gens = hl1_comparison.demo_fleet()
        caps = np.array([g.capacity for g in gens], np.float32)
        fors = np.array([g.for_rate for g in gens], np.float32)
        step = 10.0
        n = copt.grid_points_for(float(caps.sum()), step)
        probs = copt.build_copt(caps, fors, step, n,
                                device=args.device).cpu().numpy()
        _figures([
            (f"{args.out}/markov_process.png",
             lambda f: report.plot_markov_education(
                 times, tt, pdf, single, cap, total, f)),
            (f"{args.out}/parameter_estimation.png",
             lambda f: report.plot_parameter_estimation(est, f)),
            (f"{args.out}/copt_adequacy.png",
             lambda f: report.plot_copt_adequacy(
                 probs, step, float(caps.sum()),
                 hl1_comparison.sinusoidal_load(), f))])
        print(json.dumps({"figures": ["markov_process.png",
                                      "parameter_estimation.png",
                                      "copt_adequacy.png"],
                          "out": args.out}))
    elif args.study == "planning":
        from powersystemsreliabilityassessment_tpu_torch.studies import (
            planning_elu)
        from powersystemsreliabilityassessment_tpu_torch.utils import report
        fleet = planning_elu.demo_planning_fleet(args.hydro_hours)
        res = planning_elu.run_elu_comparison(fleet, mc_years=args.mc_years,
                                              device=args.device)
        print(json.dumps(res.to_dict()))
        os.makedirs("results", exist_ok=True)
        _figures([("results/tail_risk.png",
                   lambda f: report.plot_tail_risk(res, f))])
    elif args.study == "multiarea":
        from powersystemsreliabilityassessment_tpu_torch.studies import (
            multiarea_demo)
        if args.system == "rts96":
            out = multiarea_demo.run_rts96_hl15(args.years,
                                                device=args.device,
                                                mesh=mesh)
            if lead:
                print(json.dumps(out))
        elif args.system == "ring":
            multiarea_demo.run_nring_demo(args.areas, args.years,
                                          device=args.device, mesh=mesh)
        elif args.system == "case":
            from powersystemsreliabilityassessment_tpu_torch.core.matpower_io import (  # noqa: E501
                resolve_case)
            out = multiarea_demo.run_case_hl15(
                resolve_case(args.case), args.years, device=args.device,
                mesh=mesh)
            if lead:
                print(json.dumps(out))
        else:
            multiarea_demo.run_demo(args.years, device=args.device,
                                    mesh=mesh)
    elif args.study == "scaleup":
        from powersystemsreliabilityassessment_tpu_torch.studies import scaleup
        out = scaleup.run(case_name=args.case, samples=args.samples,
                          antithetic=args.antithetic, device=args.device,
                          mesh=mesh)
        if lead:
            print(json.dumps(out))
    elif args.study == "bench":
        p.error("bench: the port's benchmark does not exist yet (ROADMAP.md "
                "Queue 1 item 1); bench.py times the JAX package")


if __name__ == "__main__":
    main()
