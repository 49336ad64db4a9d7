"""Fused sampler + first-pass certificate (K4).

Port of ``powersystemsreliabilityassessment_tpu/ops/fused_sampler_cert.py``
(``supported``, ``sample_certify_quick`` and the kernel of
``_call_kernel``). Per state lane, the kernel of
``csrc/fused_sampler_cert.cu`` draws the outage indicators (K6's
thresholds and Philox counters, so the same seed words give exactly the
states of ``ops/hw_sampler.py``) or takes explicit states, computes the
exact copper deficit, the hint-shaped shed candidate at that bound, the
locally balanced dispatch and the LODF-corrected post-outage flows, and
certifies the lane only if every flow clears its rating by more than a
rigorous bound on the rounding (the guard band below). Repair, the
rank-k Woodbury check and a plain re-check of the band's lanes run
downstream on a compacted buffer (``dcopf.certify_finish``).

**The guard band, derived for float32 FMA arithmetic.** The reference's
``EPS_HIGH = 2^-14`` models its TPU dots (bf16 products and an emulated
bf16x3 scheme, inflated ~4x). On the card every product here is a
float32 FMA chain, so the band is derived again, as a bound on the
kernel's own rounding against exact arithmetic on the float32 data.
With u = 2^-24 and gamma_n = n u / (1 - n u), a float32 sum of n
products in any order errs by at most gamma_n times the sum of the
products' magnitudes (Higham, Accuracy and Stability of Numerical
Algorithms, 3.1). Per lane and branch l:

* a bus injection inj_b = (units' dispatch at b + shed at b) - load_b
  sums deg_b + 1 <= ng + nd + 1 terms, so with a_b = (the two sums) +
  load_b (>= |inj_b|, every term being nonnegative) it errs by at most
  gamma_(deg_b + 1) a_b;
* a flow f_l = sum_b inj_b PTDF[l, b] (nb FMAs) then errs by at most
  gamma_(ng + nd + 1 + nb) S_l, S_l = sum_b a_b |PTDF[l, b]|;
* a post-outage flow p_l = f_l + f_k LODF[l, k] (one outaged branch k)
  errs by at most err(f_l) + |LODF[l, k]| err(f_k) + gamma_2 (|f_l| +
  |f_k LODF[l, k]|).

So with b_l = eps (S_l + |f_l|) the bound is b_l + |LODF[l, k]| b_k, and
``guard_eps`` = 2 (ng + nd + nb + 3) u: the largest gamma above with an
inflation of 2 for the bound's own float32 sums and the second-order
terms. RTS-24: 154 u = 9.2e-6, ~2^-16.7 (the reference's 2^-14 is
1024 u). A lane is certified only if |p_l| <= rate_l + 1e-4 - bound for
every l, which proves its candidate feasible at rate + 1e-4 in exact
arithmetic: more than ``certify_states`` checks (its float32 test has no
band). That the first-pass mask lies inside ``certify_states``'
certified set is checked (tests, ``chip_smoke.py`` k4), not proven, as
in the reference. The constant matters: deficit optima bind a line with
zero margin, so their margin is the 1e-4 tolerance, and on RTS-24 peak
states with the calibrated hint a band of 2^-14 routes ~8% of all lanes
to ``certify_finish`` while 2^-16 routes none (the CPU plain version on
65,536 K6 states). The band never certifies a lane: those it routes are
decided by ``certify_finish``'s plain float32 re-check at the standard
tolerance. Islanding outages (LODF sentinel 1e6) get a huge bound and
always take the finish.

Scope, as the reference: systems whose every dimension is <= 128
(RTS-24-class, ``supported``) and the batch-constant NSQ peak load.

``sample_certify_quick`` is the wrapper: on CUDA it launches the kernel
(or raises); on the CPU it runs ``sample_certify_quick_plain``, the
kernel's arithmetic in plain PyTorch. ``launches`` counts kernel
launches. The kernel runs one thread per state lane; ``launch_shape``
sizes its blocks and chooses what it keeps in shared memory.
"""
from __future__ import annotations

import torch

from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.ops import (
    certify_kernel as ck, cuda_build, hw_sampler)

U_F32 = 2.0 ** -24   # float32 unit roundoff
# Inflation of the guard band over the worst-case gamma (module docstring).
BAND_INFLATION = 2.0

launches = {"sample_certify_quick": 0}

# The launch shape (csrc/fused_sampler_cert.cu): lanes a block and
# threads a lane as K5's (``certify_kernel.lanes_and_split``), the split
# stored in the stage bits from SPLIT_SHIFT; the shared memory a block
# may take (the H100's 227 KB); branches a flow pass carries.
WARP = ck.WARP
MAX_LANES = ck.MAX_LANES
MAX_SPLIT = ck.MAX_SPLIT
MAX_THREADS = ck.MAX_THREADS
SPLIT_SHIFT = 8
THREADS_PER_SM = ck.THREADS_PER_SM
SMEM_PER_BLOCK = ck.SMEM_PER_BLOCK
CHUNK = ck.CHUNK


def guard_eps(sys) -> float:
    """The guard band's relative constant for ``sys`` (module docstring):
    2 (ng + nd + nb + 3) u. Kernel and plain version both use it."""
    return BAND_INFLATION * (sys.n_gen + sys.n_load + sys.n_bus + 3) * U_F32


def supported(sys) -> bool:
    """Kernel applicability: every dimension <= 128 (reference
    ``ops/fused_sampler_cert.py::supported``)."""
    return max(sys.n_comp, sys.n_bus, sys.n_branch, sys.n_gen,
               sys.n_load) <= ck.MAX_DIM


def check_supported(sys) -> None:
    """Raise ValueError unless :func:`supported`."""
    if not supported(sys):
        raise ValueError(f"fused sampler-certificate: {sys.name} has a "
                         f"dimension above {ck.MAX_DIM}; use the default "
                         "path")


def hint_row(sys, shed_hint) -> torch.Tensor:
    load = sys.load_pd.to(torch.float32)
    if shed_hint is None:
        return load / load.sum()     # the load-proportional candidate
    return torch.as_tensor(shed_hint, dtype=torch.float32,
                           device=sys.device)


def sample_certify_quick_plain(sys, batch: int, seeds=None, thresh=None,
                               down=None, hint=None,
                               eps: float | None = None):
    """Plain PyTorch version of the K4 kernel, statement for statement:
    K6's states from ``seeds`` / ``thresh`` (or ``down``, bool [batch,
    n_comp]), then the first-pass certificate under the shed direction
    ``hint`` ([n_load]) and the band ``eps`` (default :func:`guard_eps`;
    :func:`launch` takes the same argument, so kernel and plain version
    can be compared at a wider band that routes lanes).
    Returns (down, ok1 [B] bool, deficit [B], shed [B, nd])."""
    if down is None:
        down = hw_sampler.sample_states_hw_plain(seeds, thresh, batch)
    f32 = torch.float32
    eps = guard_eps(sys) if eps is None else eps
    ng = sys.n_gen
    dn = down.to(f32)
    gd, brd = dn[:, :ng], dn[:, ng:]
    load = sys.load_pd.to(f32)
    pmax = sys.gen_pmax.to(f32)
    load_tot, pmax_tot = load.sum(), pmax.sum()
    # Exact copper deficit and the hint-shaped candidate at that bound.
    cap = pmax_tot - (gd * pmax).sum(1)
    deficit = torch.clamp_min(load_tot - cap, 0.0)
    cand = torch.minimum(hint[None, :] * deficit[:, None], load[None, :])
    tot0 = cand.sum(1)
    head = load[None, :] - cand
    head_lt = torch.clamp_min(head.sum(1), 1e-9)
    cand = torch.minimum(cand + head * ((deficit - tot0) / head_lt)[:, None],
                         load[None, :])
    served = load_tot - deficit
    gcap = pmax[None, :] * (1.0 - gd)
    lb = load[None, :].expand(down.shape[0], sys.n_load)
    disp = dcopf._dispatch_candidate(sys, gcap, lb, cand, served)
    # Flows of the candidate and their rounding bound (module docstring).
    s = disp @ sys.gen_bus_onehot.T + cand @ sys.load_onehot.T
    load_bus = load @ sys.load_onehot.T
    inj, a = s - load_bus, s + load_bus
    flows = inj @ sys.ptdf.T
    bnd = eps * (a @ sys.ptdf.abs().T + flows.abs())
    post = (flows + (brd * flows) @ sys.lodf.T) * (1.0 - brd)
    bnd = bnd + (brd * bnd) @ sys.lodf.abs().T
    clear = ~(post.abs() > (sys.br_rate + 1e-4) - bnd)
    ok1 = clear.all(1) & (brd.sum(1) <= 1)
    return down, ok1, deficit, cand


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def launch_shape(ng: int, nd: int, nl: int, nb: int, batch: int,
                 n_sms: int, lanes: int | None = None,
                 split: int | None = None) -> tuple[int, int, int]:
    """``(lanes per block, stage bits, dynamic shared bytes)`` of a K4
    launch for a system of ``ng`` units, ``nd`` loads, ``nl`` branches
    and ``nb`` buses, in the layout of csrc/fused_sampler_cert.cu: the
    broadcast vectors (``quick_small_words``), PTDF with rows padded to
    CHUNK, LODF where it fits (else the kernel reads it through the
    cache), then ``quick_lane_bytes`` a lane (its bus sums and the
    exchange region of its state bytes and shed floats). The kernel
    reads back the lanes a block from the shared bytes.

    Threads a lane (``split``): the largest power of two, up to
    MAX_SPLIT, that the batch needs to give each of the ``n_sms`` SMs
    THREADS_PER_SM threads (262,144 lanes: 1; 8,192: 4). Lanes a block:
    as many warps as still give each SM a block, at most MAX_LANES and
    MAX_THREADS / split, at least one warp (262,144: 128; 8,192: 32, 256
    blocks on 132 SMs). ``lanes`` and ``split`` override the choices.
    With every dimension <= 128 the vectors, PTDF and 128 lanes take at
    most ~197 KB, so only LODF is ever left out."""
    lanes, split = ck.lanes_and_split(batch, n_sms, lanes, split)
    nc = ng + nl
    small = 4 * _round4(nc + 3 * ng + 3 * nd + 3 * nb + nl + 2)
    ptdf = 4 * nb * ((nl + CHUNK - 1) // CHUNK * CHUNK)
    lane = 4 * nb + _round4(max(nc, 4 * nd))
    used = small + ptdf + lanes * lane
    if used > SMEM_PER_BLOCK:
        raise ValueError("sample_certify_quick: dimensions above "
                         f"{ck.MAX_DIM} do not fit the kernel")
    stage = ck.STAGE_PTDF | (split.bit_length() - 1) << SPLIT_SHIFT
    lodf = 4 * _round4(nl * nl)
    if used + lodf <= SMEM_PER_BLOCK:
        stage |= ck.STAGE_LODF
        used += lodf
    return lanes, stage, used


def kernel_operands(sys, hint: torch.Tensor):
    """(float buffer, int buffer, thresholds) of the K4 kernel for
    ``sys`` and the shed direction ``hint``: the network buffers of
    ``certify_kernel.network_buffers`` followed by the load row, the
    hint, the bus loads and (load total, capacity total), and K6's
    thresholds. They are constant for a (system, hint) pair: the study
    step packs them once, not in every batch (the launch shape, which
    depends on the batch, is chosen at each launch)."""
    load = sys.load_pd.to(torch.float32)
    fbuf, ibuf = ck.network_buffers(sys, extras=(
        load, hint, load @ sys.load_onehot.T,
        torch.stack([load.sum(), sys.gen_pmax.to(torch.float32).sum()])))
    thresh = hw_sampler.bernoulli_thresholds(sys.unavail, sys.always_up_nsq)
    return fbuf, ibuf, thresh


def launch(sys, batch: int, seeds, down, operands,
           eps: float | None = None):
    """One K4 launch on prepared ``kernel_operands``: random-state mode
    under the key ``seeds`` (``down`` None), or explicit ``down``. ``eps``
    is the guard band's constant (default :func:`guard_eps`)."""
    dev = sys.device
    ng, nd, nl, nb = sys.n_gen, sys.n_load, sys.n_branch, sys.n_bus
    nc = sys.n_comp
    fbuf, ibuf, thresh = operands
    _, stage, smem = launch_shape(ng, nd, nl, nb, batch, ck.sm_count(dev))
    if down is not None:
        if down.dtype != torch.bool or tuple(down.shape) != (batch, nc) \
                or down.device != dev:
            raise ValueError("sample_certify_quick: down must be a bool "
                             f"tensor [{batch}, {nc}] on {dev}")
        down = down.contiguous()
        seeds = thresh = None
    eps = guard_eps(sys) if eps is None else eps
    ptr = lambda t: None if t is None else t.data_ptr()
    out = torch.empty((batch, nc), dtype=torch.bool, device=dev)
    ok1 = torch.empty(batch, dtype=torch.bool, device=dev)
    deficit = torch.empty(batch, dtype=torch.float32, device=dev)
    shed = torch.empty((batch, nd), dtype=torch.float32, device=dev)
    err = cuda_build.library().psra_fused_sampler_cert(
        ptr(seeds), ptr(thresh), ptr(down), fbuf.data_ptr(),
        ibuf.data_ptr(), batch, ng, nd, nl, nb, stage, smem, eps,
        out.data_ptr(), ok1.data_ptr(), deficit.data_ptr(), shed.data_ptr(),
        cuda_build.stream_handle(out))
    cuda_build.check_launch(err, "sample_certify_quick")
    launches["sample_certify_quick"] += 1
    return out, ok1, deficit, shed


def sample_certify_quick(generator: torch.Generator | None, sys, batch: int,
                         down: torch.Tensor | None = None, shed_hint=None,
                         operands=None):
    """Draw ``batch`` NSQ states and first-pass-certify them, fused;
    mirrors reference ``ops/fused_sampler_cert.py::sample_certify_quick``.

    Returns ``(down [batch, n_comp] bool, ok1 [batch] bool, deficit
    [batch] f32, shed [batch, n_load] f32)``. The states are K6's
    (``ops/hw_sampler.py``) under two seed words drawn from ``generator``
    on the system's device; pass ``down`` (bool [batch, n_comp]) instead
    to certify explicit states (``generator`` is then unused).
    ``shed_hint`` ([n_load], sums to 1; ``dcopf.calibrate_shed_hint``)
    directs the shed candidate; omitted, it is load-proportional. The
    certificate is first-pass only: ``dcopf.certify_finish`` completes
    it. The load is the batch-constant NSQ peak (``sys.load_pd``).
    ``operands``: :func:`kernel_operands` of ``sys`` and ``shed_hint``,
    packed once by a caller that launches many times (packing takes some
    40 small launches); packed here when omitted.
    CUDA: the K4 kernel; CPU: :func:`sample_certify_quick_plain`.
    """
    check_supported(sys)
    seeds = None if down is not None else \
        hw_sampler.seed_words(generator, sys.device)
    if sys.device.type == "cpu":
        thresh = hw_sampler.bernoulli_thresholds(sys.unavail,
                                                 sys.always_up_nsq)
        return sample_certify_quick_plain(sys, batch, seeds, thresh, down,
                                          hint_row(sys, shed_hint))
    if operands is None:
        operands = kernel_operands(sys, hint_row(sys, shed_hint))
    return launch(sys, batch, seeds, down, operands)
