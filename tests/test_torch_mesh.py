"""PyTorch port: the scenario mesh (``parallel/mesh.py``) on two gloo ranks
on the CPU, held against the JAX package's two-device mesh.

Three launches of ``python -m torch.distributed.run --standalone
--nproc_per_node 2``, each in a subprocess with a timeout (a failing rank
fails its test; it never hangs the suite), the process group bounded by
``mesh.TIMEOUT`` (60 s):

* a worker script written into ``tmp_path`` (it imports torch and the
  port only, never this module) that runs, on both ranks: the reduction
  of tests/test_parallel.py's arrays (``batch_moments`` on each rank's
  ``shard_batch`` slice, then ``psum_moments``); the SEQ step's packed
  outputs with their per-year vectors in rank-owned slots; 256 RTS-24
  ``comp_down`` states at peak load through ``evaluate_states``,
  ``batch_moments`` and ``psum_moments``; a short SEQ study at two
  years a batch; a short split SEQ study at four; the multi-area block
  sums; both HL1 Monte Carlo engines; an NSQ study run whole, and run in
  two parts through a checkpoint;
* the NSQ command line under torchrun with ``--device cpu``;
* a worker whose rank 1 raises before its first collective.

The reduction and the gather are held against the reference's
``shard_map`` over two of the 8 virtual CPU devices (tests/conftest.py):
the sums at rel 1e-6, the gathered vectors exactly. The evaluation is
held as tests/test_torch_nsq.py holds ``evaluate_states`` to the
reference: each lane's DNS within 0.05 MW (``ORACLE_TOL_MW``), equal
failure flags and component counts, the sums within 0.05 MW a lane. The
studies are held at rel 1e-6 (the split study's NLC and entered parents
exactly) against an in-process reproduction that
runs each rank's step at its share of the batch with that rank's
generator and adds rank 0's and rank 1's float32 partials, as the
all-reduce does. torchrun gives each rank one thread; so does this
module, so the two sides round their sums alike.
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import dcopf as ref_dcopf
from powersystemsreliabilityassessment_tpu.parallel import (
    accumulators as ref_acc)

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    copper_sheet, dcopf, multiarea)
from powersystemsreliabilityassessment_tpu_torch.parallel import (
    accumulators, mesh as meshlib)
from powersystemsreliabilityassessment_tpu_torch.studies import (
    hl1_comparison, hl2_nsq, hl2_seq, multiarea_demo)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 2
LAUNCH_TIMEOUT_S = 240
REL = 1e-6
ORACLE_TOL_MW = 0.05

# The configurations the worker runs and the reproduction repeats.
EVAL_STATES = 256
SEQ_KW = dict(years_per_device=1, hours=168, max_lp=256)
SEQ_CFG = dict(max_years=4, cov_threshold=0.0, seed=3)
MA_HOURS, MA_YEARS, MA_SEED = 336, 4, 1
HL1 = dict(iterations=4000, seed=0, batch=1000)
HL1_SEQ = dict(years=4, seed=1, batch=2)
SPLIT_KW = dict(years_per_device=2, hours=168, max_lp=64)
SPLIT_CFG = dict(max_years=4, cov_threshold=0.0, seed=6)
SPLIT_LEVEL_MW = 300.0
NSQ_CFG = dict(batch_size=256, max_samples=768, seed=13)
CLI_ARGS = ["nsq", "--samples", "2048", "--batch", "2048", "--seed", "5",
            "--device", "cpu"]

WORKER = r'''
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    dcopf, multiarea)
from powersystemsreliabilityassessment_tpu_torch.parallel import (
    accumulators, mesh as meshlib)
from powersystemsreliabilityassessment_tpu_torch.runtime.checkpoint import (
    Checkpointer)
from powersystemsreliabilityassessment_tpu_torch.studies import (
    hl1_comparison, hl2_nsq, hl2_seq, hl2_seq_split, multiarea_demo)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig, MCSConfig)

out_dir, conf = sys.argv[1], json.loads(sys.argv[2])
assert meshlib.init_from_env("cpu")
mesh = meshlib.scenario_mesh("cpu")
assert (mesh.size, str(mesh.device)) == (2, "cpu")
r = mesh.rank
arrays, result = {}, {}

# The reduction, on tests/test_parallel.py's arrays at two devices.
rng = np.random.default_rng(0)
n = 2 * 4
dns = rng.uniform(0, 10, (n,)).astype(np.float32)
nodal = rng.uniform(0, 1, (n, 24)).astype(np.float32)
comp = rng.uniform(size=(n, 71)) < 0.3
sh = lambda a: meshlib.shard_batch(mesh, torch.as_tensor(a))
m = accumulators.psum_moments(mesh, accumulators.batch_moments(
    sh(dns), sh(nodal), sh(dns > 5), sh(comp)))
arrays["moments"] = accumulators.pack_moments(m).numpy()

# The SEQ step's packed outputs: per-year vectors in rank-owned slots.
g = np.random.default_rng((11, r))
f = lambda *s: torch.as_tensor(g.uniform(0, 9, s).astype(np.float32))
out = (f(3), f(3), f(3), f(3), f(3), f(24), f(71), f(), f(), f(), f(3),
       f(3))
arrays["seq_local"] = hl2_seq._pack(out).numpy()
arrays["seq_slots"] = meshlib.psum(mesh, hl2_seq._pack(out, mesh)).numpy()

# The whole evaluation of 256 RTS-24 states at peak load.
sys_ = build_system(cases.rts24(), device="cpu")
down = np.random.default_rng(29).uniform(size=(conf["eval_states"],
                                               sys_.n_comp)) \
    < 2 * sys_.unavail.numpy()[None, :]
d = sh(down)
res = dcopf.evaluate_states(sys_, d, sys_.load_pd[None].expand(len(d), -1))
m = accumulators.psum_moments(mesh, accumulators.batch_moments(
    res.dns_mw, res.nodal_mw, res.failure, d))
arrays["eval_moments"] = accumulators.pack_moments(m).numpy()
arrays["eval_dns"] = meshlib.psum(mesh, meshlib.slot(mesh, res.dns_mw)).numpy()
arrays["eval_fail"] = meshlib.psum(
    mesh, meshlib.slot(mesh, res.failure.float())).numpy()

# A short SEQ study, two years a batch.
seq = hl2_seq.run_seq_study(cases.rts24(), MCSConfig(**conf["seq_cfg"]),
                            log_every=0, mesh=mesh, **conf["seq_kw"])
result["seq"] = dict(annual_ens=seq.annual_ens, annual_dlc=seq.annual_dlc,
                     annual_nlc=seq.annual_nlc, years=seq.years,
                     nodal=seq.nodal_eens_mwh_yr.tolist(),
                     comp=seq.comp_importance.tolist(),
                     overflow=seq.overflow_hours)

# A short split SEQ study, two years a rank a batch.
sp = hl2_seq_split.run_seq_split_study(
    cases.rts24(), MCSConfig(**conf["split_cfg"]),
    hl2_seq_split.SplitConfig(level_mw=conf["split_level"]), log_every=0,
    mesh=mesh, **conf["split_kw"])
result["split"] = dict(annual_ens=sp.annual_ens, annual_nlc=sp.annual_nlc,
                       entered=sp.split_entered, years=sp.years)

# The multi-area block sums and the HL1 Monte Carlo engines.
loss, eue, ypb = multiarea.multiarea_batches(
    multiarea_demo.demo_system(conf["ma_hours"]), multiarea.INTERCONNECTED,
    conf["ma_years"], seed=conf["ma_seed"], ipm=IPMConfig(iterations=20),
    years_per_device=1, mesh=mesh)
arrays["ma_loss"], arrays["ma_eue"], result["ma_ypb"] = loss, eue, ypb
hl1 = hl1_comparison.run_non_sequential_mc(
    hl1_comparison.demo_fleet(), hl1_comparison.sinusoidal_load(),
    mesh=mesh, **conf["hl1"])
result["hl1"] = dict(lole=hl1.lole_hours_yr, eue=hl1.eue_mwh_yr,
                     history=hl1.convergence_history,
                     means=hl1.batch_means)
hl1s = hl1_comparison.run_sequential_mc(
    hl1_comparison.demo_fleet(), hl1_comparison.sinusoidal_load(),
    mesh=mesh, **conf["hl1_seq"])
result["hl1_seq"] = dict(means=hl1s.batch_means)

# NSQ: whole, then in two parts through a checkpoint rank 0 writes.
cfg = dict(conf["nsq_cfg"])
full = hl2_nsq.run_nsq_study(cases.rts24(), MCSConfig(**cfg), log_every=0,
                             mesh=mesh)
ck = Checkpointer(f"{out_dir}/nsq.ckpt")
half = dict(cfg, max_samples=cfg["max_samples"] // 2)
hl2_nsq.run_nsq_study(cases.rts24(), MCSConfig(**half), log_every=0,
                      mesh=mesh, checkpointer=ck, checkpoint_every=1)
dist.barrier()        # rank 0's last save is on disk before any restore
saved = ck.restore()["batch_idx"]
resumed = hl2_nsq.run_nsq_study(cases.rts24(), MCSConfig(**cfg),
                                log_every=0, mesh=mesh, checkpointer=ck,
                                checkpoint_every=1)
for tag, s in (("nsq_full", full), ("nsq_resumed", resumed)):
    result[tag] = dict(edns=s.edns_mw, plc=s.plc, beta=s.beta,
                       samples=s.samples, edns_history=s.edns_history,
                       nodal=s.nodal_eens_mwh_yr.tolist())
result["nsq_saved_batch"] = saved

np.savez(f"{out_dir}/rank{r}.npz", **arrays)
with open(f"{out_dir}/rank{r}.json", "w") as fh:
    json.dump(result, fh)
dist.destroy_process_group()
'''

FAILING = r'''
import torch
from powersystemsreliabilityassessment_tpu_torch.parallel import (
    mesh as meshlib)

meshlib.init_from_env("cpu")
mesh = meshlib.scenario_mesh("cpu")
if mesh.rank == 1:
    raise RuntimeError("rank 1 fails before its first collective")
meshlib.psum(mesh, torch.ones(4))
'''


def _torchrun(args, tmp_path, tee=False):
    """``torchrun --standalone --nproc_per_node 2 args`` from the repo
    root in a subprocess: (completed process, wall seconds). Past
    LAUNCH_TIMEOUT_S torchrun is stopped (it stops its workers), then
    killed, and the test fails."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(RANKS)]
    if tee:
        cmd += ["--log-dir", str(tmp_path / "logs"), "--tee", "3"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd + args, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.terminate()          # torchrun stops its workers, then exits
        try:
            proc.communicate(timeout=30)
        finally:
            proc.kill()
            proc.communicate()
        raise
    return (subprocess.CompletedProcess(proc.args, proc.returncode, out, err),
            time.perf_counter() - t0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The worker's outputs on both ranks: [(arrays, result)] by rank."""
    tmp = tmp_path_factory.mktemp("mesh")
    script = tmp / "worker.py"
    script.write_text(WORKER)
    conf = dict(eval_states=EVAL_STATES, seq_cfg=SEQ_CFG, seq_kw=SEQ_KW,
                ma_hours=MA_HOURS, ma_years=MA_YEARS, ma_seed=MA_SEED,
                hl1=HL1, hl1_seq=HL1_SEQ, nsq_cfg=NSQ_CFG,
                split_kw=SPLIT_KW, split_cfg=SPLIT_CFG,
                split_level=SPLIT_LEVEL_MW)
    proc, _ = _torchrun([str(script), str(tmp), json.dumps(conf)], tmp)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [(dict(np.load(tmp / f"rank{r}.npz")),
             json.loads((tmp / f"rank{r}.json").read_text()))
            for r in range(RANKS)]


def _ref_mesh():
    return Mesh(np.asarray(jax.devices()[:RANKS]), ("scenarios",))


def test_ranks_return_the_same_results(ranks):
    (a0, r0), (a1, r1) = ranks
    assert r0 == r1
    for k in a0:
        if k != "seq_local":
            np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)


def test_psum_moments_matches_reference_two_device_mesh(ranks):
    rng = np.random.default_rng(0)
    n = RANKS * 4
    dns = rng.uniform(0, 10, (n,)).astype(np.float32)
    nodal = rng.uniform(0, 1, (n, 24)).astype(np.float32)
    comp = rng.uniform(size=(n, 71)) < 0.3

    def f(d, no, fl, cm):
        return ref_acc.psum_moments(ref_acc.batch_moments(d, no, fl, cm))

    ref = jax.jit(shard_map(
        f, mesh=_ref_mesh(), in_specs=(P("scenarios"),) * 4,
        out_specs=ref_acc.MOMENTS_OUT_SPECS, check_vma=False,
    ))(dns, nodal, dns > 5, comp)
    got, _ = accumulators.unpack_moments(ranks[0][0]["moments"], 24)
    assert float(got.n) == float(ref.n) == n
    for field in accumulators.BatchMoments._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, field)),
                                   np.asarray(getattr(ref, field)),
                                   rtol=REL, err_msg=field)


def test_seq_slots_match_reference_all_gather(ranks):
    locals_ = [a["seq_local"] for a, _ in ranks]
    got = ranks[0][0]["seq_slots"]
    Y, nb = 3, 24
    per = [hl2_seq._fields(v, Y, nb, 7) for v in locals_]

    def gather(a):
        return jax.lax.all_gather(a, "scenarios", tiled=True)

    def psum(a):
        return jax.lax.psum(a, "scenarios")

    sharded = lambda xs: np.concatenate(xs)        # rank-major, as sharded
    ref_gather = jax.jit(shard_map(
        gather, mesh=_ref_mesh(), in_specs=P("scenarios"), out_specs=P(),
        check_vma=False))
    ref_psum = jax.jit(shard_map(
        psum, mesh=_ref_mesh(), in_specs=P("scenarios"), out_specs=P(),
        check_vma=False))
    years, nodal, comp, loss, n_over, n_inf = hl2_seq._fields(
        got, RANKS * Y, nb, 7)
    for j in range(7):
        want = np.asarray(ref_gather(sharded([p[0][j] for p in per])))
        np.testing.assert_array_equal(years[j], want)
    np.testing.assert_array_equal(
        nodal, np.asarray(ref_psum(sharded([p[1] for p in per]))))
    np.testing.assert_array_equal(
        comp, np.asarray(ref_psum(sharded([p[2] for p in per]))))
    for j, got_s in ((3, loss), (4, n_over), (5, n_inf)):
        assert got_s == np.float32(per[0][j]) + np.float32(per[1][j])


def test_evaluation_on_two_ranks_matches_reference_shard_map(ranks):
    arrays = ranks[0][0]
    ref_sys = ref_build_system(ref_cases.rts24())
    down = np.random.default_rng(29).uniform(
        size=(EVAL_STATES, ref_sys.n_comp)) \
        < 2 * np.asarray(ref_sys.unavail)[None, :]
    load = np.tile(np.asarray(ref_sys.load_pd)[None, :], (EVAL_STATES, 1))

    def f(d, ld):
        r = ref_dcopf.evaluate_states(ref_sys, d, ld)
        return (ref_acc.psum_moments(ref_acc.batch_moments(
            r.dns_mw, r.nodal_mw, r.failure, d)), r.dns_mw, r.failure)

    m_ref, dns_ref, fail_ref = jax.jit(shard_map(
        f, mesh=_ref_mesh(), in_specs=(P("scenarios"), P("scenarios")),
        out_specs=(ref_acc.MOMENTS_OUT_SPECS, P("scenarios"),
                   P("scenarios")), check_vma=False,
    ))(jnp.asarray(down), jnp.asarray(load))
    m, _ = accumulators.unpack_moments(arrays["eval_moments"],
                                       ref_sys.n_bus)
    dns_ref = np.asarray(dns_ref)
    assert (dns_ref > 0).sum() >= 10
    assert np.abs(arrays["eval_dns"] - dns_ref).max() <= ORACLE_TOL_MW
    np.testing.assert_array_equal(arrays["eval_fail"] > 0,
                                  np.asarray(fail_ref))
    assert float(m.n) == float(m_ref.n) == EVAL_STATES
    assert float(m.sum_flag) == float(m_ref.sum_flag)
    np.testing.assert_array_equal(m.sum_comp_fail,
                                  np.asarray(m_ref.sum_comp_fail))
    assert abs(float(m.sum_dns) - float(m_ref.sum_dns)) <= \
        ORACLE_TOL_MW * EVAL_STATES
    assert abs(float(m.sum_nodal.sum()) - float(m_ref.sum_nodal.sum())) \
        <= ORACLE_TOL_MW * EVAL_STATES


def test_rank_generators():
    # Rank 0 is the generator of a study without a mesh, bit for bit.
    for seed, i in ((0, 0), (13, 7)):
        want = hl2_nsq._generator((seed, i), "cpu").initial_seed()
        assert hl2_nsq.batch_generator(seed, i, "cpu").initial_seed() == want
        assert hl2_nsq.batch_generator(seed, i, "cpu", rank=0
                                       ).initial_seed() == want
    # Rank 1 draws another stream than rank 0, and than the pilot's
    # (seed, round, chunk) that a (seed, batch, rank) derivation would
    # replay.
    draw = lambda g: torch.rand(64, generator=g)
    r0 = draw(hl2_nsq.batch_generator(5, 1, "cpu"))
    r1 = draw(hl2_nsq.batch_generator(5, 1, "cpu", rank=1))
    pilot = draw(hl2_nsq.pilot_generator(5, 1, 1, "cpu"))
    assert not torch.equal(r0, r1) and not torch.equal(r1, pilot)


def test_one_member_mesh_equals_no_mesh(tmp_path):
    # No process group: a one-member mesh without a group, no collective.
    mesh = meshlib.scenario_mesh("cpu")
    assert mesh == meshlib.ScenarioMesh(torch.device("cpu"))
    t = torch.arange(4.0)
    assert meshlib.psum(mesh, t) is t
    assert torch.equal(meshlib.shard_batch(mesh, t), t)
    # A group of one rank takes the mesh's path (the pre-passes'
    # broadcast, one all_reduce a step, the views of the summed vector)
    # and returns the bits of a study given no mesh.
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1, timeout=meshlib.TIMEOUT)
    try:
        mesh = meshlib.scenario_mesh("cpu")
        assert mesh.group is not None and mesh.size == 1
        cfg = MCSConfig(batch_size=128, max_samples=128, seed=4)
        a = hl2_nsq.run_nsq_study(cases.rts24(), cfg, device="cpu",
                                  log_every=0)
        b = hl2_nsq.run_nsq_study(cases.rts24(), cfg, log_every=0,
                                  mesh=mesh)
        assert a.edns_history == b.edns_history and a.beta == b.beta
        np.testing.assert_array_equal(a.nodal_eens_mwh_yr,
                                      b.nodal_eens_mwh_yr)
        scfg = MCSConfig(max_years=2, cov_threshold=0.0, seed=2)
        kw = dict(SEQ_KW, control_variate=True)
        a = hl2_seq.run_seq_study(cases.rts24(), scfg, device="cpu",
                                  log_every=0, **kw)
        b = hl2_seq.run_seq_study(cases.rts24(), scfg, log_every=0,
                                  mesh=mesh, **kw)
        assert a.annual_ens == b.annual_ens and a.annual_nlc == b.annual_nlc
        np.testing.assert_array_equal(a.comp_importance, b.comp_importance)
    finally:
        dist.destroy_process_group()


def _rank_sum(parts):
    """Rank 0's float32 partials plus rank 1's, as the all-reduce adds."""
    return np.asarray(parts[0], np.float32) + np.asarray(parts[1], np.float32)


def test_seq_study_on_two_ranks_matches_reproduction(ranks):
    got = ranks[0][1]["seq"]
    sys_ = build_system(cases.rts24(), device="cpu")
    compat, hours = CompatFlags(), SEQ_KW["hours"]
    from powersystemsreliabilityassessment_tpu_torch.core import load_profile
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    mt = twostate.mean_times(cases.rts24())
    step = hl2_seq.make_seq_batch_step(
        sys_, SEQ_KW["years_per_device"], compat, IPMConfig(), hours,
        chronological.default_num_draws(mt[:, 0], mt[:, 1], hours),
        SEQ_KW["max_lp"], load_profile.load_factors(hours))
    ens, sums = [], []
    for b in range(SEQ_CFG["max_years"] // RANKS):
        parts = [hl2_seq._pack(step(hl2_nsq.batch_generator(
            SEQ_CFG["seed"], b, "cpu", r))).numpy() for r in range(RANKS)]
        per = [hl2_seq._fields(p, 1, sys_.n_bus, 5) for p in parts]
        ens += [float(p[0][0][0]) for p in per]
        assert all(p[4] == 0 for p in per)
        sums.append(_rank_sum([p[1] for p in per]))
    assert got["years"] == SEQ_CFG["max_years"] and got["overflow"] == 0
    np.testing.assert_allclose(got["annual_ens"], ens, rtol=REL)
    nodal = np.sum(np.asarray(sums, np.float64), 0) / got["years"]
    np.testing.assert_allclose(got["nodal"], nodal, rtol=REL, atol=1e-9)


def test_split_study_on_two_ranks_matches_reproduction(ranks):
    from powersystemsreliabilityassessment_tpu_torch.core import load_profile
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_seq_split)
    got = ranks[0][1]["split"]
    sys_ = build_system(cases.rts24(), device="cpu")
    hours, Y = SPLIT_KW["hours"], SPLIT_KW["years_per_device"]
    mt = twostate.mean_times(cases.rts24())
    step = hl2_seq_split.make_split_batch_step(
        sys_, Y, CompatFlags(), IPMConfig(), hours,
        chronological.default_num_draws(mt[:, 0], mt[:, 1], hours),
        SPLIT_KW["max_lp"], load_profile.load_factors(hours),
        hl2_seq_split.SplitConfig(level_mw=SPLIT_LEVEL_MW))
    ens, nlc, entered = [], [], 0
    for b in range(SPLIT_CFG["max_years"] // (RANKS * Y)):
        for r in range(RANKS):
            per_year, _, _, _, n_over, _, n_in = hl2_seq_split._unpack(
                step(hl2_nsq.batch_generator(SPLIT_CFG["seed"], b, "cpu",
                                             r)).numpy().astype(np.float64),
                Y, sys_.n_bus)
            assert n_over == 0
            ens += per_year[0].tolist()
            nlc += per_year[2].tolist()
            entered += n_in
    assert got["years"] == SPLIT_CFG["max_years"]
    np.testing.assert_allclose(got["annual_ens"], ens, rtol=REL)
    assert got["annual_nlc"] == nlc and got["entered"] == entered > 0


def test_multiarea_and_hl1_on_two_ranks_match_reproduction(ranks):
    arrays, result = ranks[0]
    sys_ma = multiarea_demo.demo_system(MA_HOURS)
    step = multiarea.make_multiarea_batch_step(
        sys_ma, 1, multiarea.INTERCONNECTED, IPMConfig(iterations=20),
        device="cpu")
    assert result["ma_ypb"] == RANKS
    for b in range(MA_YEARS // RANKS):
        parts = [step(hl2_nsq.batch_generator(MA_SEED, b, "cpu", r))
                 for r in range(RANKS)]
        np.testing.assert_allclose(
            arrays["ma_loss"][b], _rank_sum([p[0].float() for p in parts]),
            rtol=REL)
        np.testing.assert_allclose(
            arrays["ma_eue"][b], _rank_sum([p[1] for p in parts]), rtol=REL)
    got = result["hl1"]
    fleet, load = hl1_comparison.demo_fleet(), hl1_comparison.sinusoidal_load()
    caps = torch.tensor([g.capacity for g in fleet], dtype=torch.float32)
    fors = torch.tensor([g.for_rate for g in fleet], dtype=torch.float32)
    curve = copper_sheet.LoadCurve.build(load, device="cpu")
    bpd = HL1["batch"] // RANKS
    means = []
    for b in range(HL1["iterations"] // HL1["batch"]):
        parts = []
        for r in range(RANKS):
            lole, eue, _ = copper_sheet.nsq_batch(
                hl2_nsq.batch_generator(HL1["seed"], b, "cpu", r), caps,
                fors, curve, bpd)
            parts.append([float(lole.sum()), float(eue.sum())])
        means.append(_rank_sum(parts).astype(np.float64) / HL1["batch"])
    np.testing.assert_allclose(got["means"], means, rtol=REL)
    np.testing.assert_allclose(got["lole"], np.mean(means, 0)[0], rtol=REL)
    # The sequential engine: a year a rank a batch.
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    mttf = np.asarray([g.mttf for g in fleet])
    mttr = np.asarray([g.mttr for g in fleet])
    k = chronological.default_num_draws(mttf, mttr, len(load))
    means = []
    for b in range(HL1_SEQ["years"] // HL1_SEQ["batch"]):
        parts = []
        for r in range(RANKS):
            down = chronological.sample_timeline_batch(
                hl2_nsq.batch_generator(HL1_SEQ["seed"], b, "cpu", r),
                torch.as_tensor(mttf, dtype=torch.float32),
                torch.as_tensor(mttr, dtype=torch.float32), len(load), k,
                HL1_SEQ["batch"] // RANKS)
            lole, eens, _ = copper_sheet.hourly_deficit(
                copper_sheet.capacity_series_from_down(down, caps),
                torch.as_tensor(load))
            parts.append([float(lole.sum()), float(eens.sum())])
        means.append(_rank_sum(parts).astype(np.float64) / HL1_SEQ["batch"])
    np.testing.assert_allclose(result["hl1_seq"]["means"], means, rtol=REL)


def test_nsq_resume_on_two_ranks_equals_uninterrupted(ranks):
    result = ranks[0][1]
    full, resumed = result["nsq_full"], result["nsq_resumed"]
    assert result["nsq_saved_batch"] == 2
    assert resumed == full
    assert full["samples"] == NSQ_CFG["max_samples"]


def test_nsq_cli_under_torchrun_matches_reproduction(tmp_path):
    proc, _ = _torchrun(["-m", "powersystemsreliabilityassessment_tpu_torch",
                         *CLI_ARGS, "--out", str(tmp_path / "out")],
                        tmp_path, tee=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = re.findall(r"^\[default(\d)\]:(\{.*\})$", proc.stdout, re.M)
    assert [r for r, _ in lines] == ["0"], proc.stdout[-2000:]
    got = json.loads(lines[0][1])
    assert (tmp_path / "out" / "nsq_results.json").exists()

    # The reproduction: run_nsq_study's own step at 1,024 states a rank.
    sys_ = build_system(cases.rts24(), device="cpu")
    cfg = MCSConfig(batch_size=2048, max_samples=2048, seed=5)
    bpd = cfg.batch_size // RANKS
    step = hl2_nsq.make_nsq_batch_step(
        sys_, bpd, CompatFlags(), IPMConfig(),
        max_lp=hl2_nsq.default_max_lp(bpd, cfg.nodal_mode),
        nodal_mode=cfg.nodal_mode, woodbury_k=cfg.woodbury_k,
        shed_hint=dcopf.calibrate_shed_hint(sys_))
    stats = accumulators.RunningStats()
    for b in range(cfg.max_samples // cfg.batch_size):
        parts = [hl2_nsq._fetch_async(step(hl2_nsq.batch_generator(
            cfg.seed, b, "cpu", r)))[0].numpy() for r in range(RANKS)]
        m, (n_over, _) = accumulators.unpack_moments(
            _rank_sum(parts).astype(np.float64), sys_.n_bus, 2)
        assert n_over == 0
        stats.update(m)
        if stats.beta <= cfg.beta_limit:
            break
    assert got["edns"] == pytest.approx(stats.edns, rel=REL)
    assert got["plc"] == pytest.approx(stats.plc, rel=REL)
    assert got["beta"] == pytest.approx(stats.beta, rel=REL)


def test_failing_rank_fails_the_launch(tmp_path):
    script = tmp_path / "failing.py"
    script.write_text(FAILING)
    proc, wall = _torchrun([str(script)], tmp_path)
    assert proc.returncode != 0
    assert "rank 1 fails before its first collective" in proc.stderr
    assert wall < meshlib.TIMEOUT.total_seconds() + 30
