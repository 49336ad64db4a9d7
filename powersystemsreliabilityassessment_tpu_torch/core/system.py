"""Device-side system representation: a dataclass of float32 tensors plus
precomputed topology matrices.

Port of ``powersystemsreliabilityassessment_tpu/core/system.py``. The
reference's ``System`` pytree becomes a frozen dataclass of tensors on
one ``device``; PTDF, LODF and the angle bounds are computed on the host
in float64 and cast once, exactly as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.core.cases import CaseData
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags)

# Tensor fields, in the reference pytree's data-field order.
_TENSOR_FIELDS = (
    "bus_pd", "gen_bus_onehot", "load_onehot", "load_pd", "incidence",
    "b_susceptance", "br_rate", "gen_pmax", "gen_pmin", "unavail",
    "mttf", "mttr", "always_up_nsq", "ptdf", "lodf", "br_transfer",
    "theta_bound")


@dataclasses.dataclass(frozen=True)
class System:
    """Struct-of-arrays power system; mirrors reference
    ``core/system.py::System``.

    Component vector convention: generators (n_gen) then branches
    (n_branch), as in the reference (nsqMain.m:90-93). Every tensor is
    float32 on ``device`` except ``always_up_nsq`` (bool).
    """

    bus_pd: torch.Tensor          # [nb] peak bus load, p.u.
    gen_bus_onehot: torch.Tensor  # [nb, ng] Cg
    load_onehot: torch.Tensor     # [nb, nd] Cd
    load_pd: torch.Tensor         # [nd] peak load at load buses, p.u.
    incidence: torch.Tensor       # [nl, nb] +1 from-bus, -1 to-bus
    b_susceptance: torch.Tensor   # [nl] 1/x, p.u.
    br_rate: torch.Tensor         # [nl] flow limit, p.u.
    gen_pmax: torch.Tensor        # [ng] p.u.
    gen_pmin: torch.Tensor        # [ng] p.u.
    unavail: torch.Tensor         # [ncomp] steady-state unavailability
    mttf: torch.Tensor            # [ncomp] hours
    mttr: torch.Tensor            # [ncomp] hours
    always_up_nsq: torch.Tensor   # [ncomp] bool, pinned up in NSQ sampling
    ptdf: torch.Tensor            # [nl, nb] intact-network PTDF (ref bus 0)
    lodf: torch.Tensor            # [nl, nl] LODF, 1e6 sentinel on islanding
    br_transfer: torch.Tensor     # [nl, nl] PTDF_l,fk - PTDF_l,tk
    theta_bound: torch.Tensor     # [nb] per-bus |theta| bound, rad

    name: str
    n_bus: int
    n_gen: int
    n_branch: int
    n_load: int
    base_mva: float

    @property
    def n_comp(self) -> int:
        return self.n_gen + self.n_branch

    @property
    def device(self) -> torch.device:
        return self.bus_pd.device


def _host_arrays(case: CaseData, compat: CompatFlags) -> dict:
    """float64 host arrays of every tensor field (reference
    ``build_system`` arithmetic, line for line)."""
    nb, ng, nl = case.n_bus, case.n_gen, case.n_branch
    base = case.base_mva
    load_idx = np.flatnonzero(case.bus_pd != 0.0)
    nd = len(load_idx)

    cg = np.zeros((nb, ng))
    cg[case.gen_bus, np.arange(ng)] = 1.0
    cd = np.zeros((nb, nd))
    cd[load_idx, np.arange(nd)] = 1.0
    inc = np.zeros((nl, nb))
    inc[np.arange(nl), case.br_from] = 1.0
    inc[np.arange(nl), case.br_to] = -1.0

    u = twostate.unavailability(case)
    mt = twostate.mean_times(case)

    bsus = 1.0 / case.br_x
    b_red = (inc.T @ (bsus[:, None] * inc))[1:, 1:]
    ptdf = np.zeros((nl, nb))
    ptdf[:, 1:] = (bsus[:, None] * inc[:, 1:]) @ np.linalg.inv(b_red)

    # LODF[l,k] = a[l,k]/(1-a[k,k]); islanding columns carry a 1e6
    # sentinel so any nonzero flow on them fails the certificate.
    a = ptdf @ inc.T
    denom = 1.0 - np.diagonal(a)
    usable = np.abs(denom) > 1e-6
    lodf = np.where(usable[None, :],
                    a / np.where(usable, denom, 1.0)[None, :], 1e6)
    np.fill_diagonal(lodf, -1.0)
    lodf = np.where(usable[None, :], lodf, 1e6)

    # Per-bus angle bound: 2x the min-path sum of rate*x from bus 0, plus
    # a 0.5 rad floor (see the reference for the derivation).
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    w = (case.br_rate / base) * case.br_x
    adj = csr_matrix((np.concatenate([w, w]),
                      (np.concatenate([case.br_from, case.br_to]),
                       np.concatenate([case.br_to, case.br_from]))),
                     shape=(nb, nb))
    dist = dijkstra(adj, directed=False, indices=0)
    dist = np.where(np.isfinite(dist), dist, np.max(w) * nb)

    always_up = np.zeros(case.n_comp, dtype=bool)
    if compat.sync_cond_always_up_nsq:
        always_up[:ng] = case.sync_cond_mask

    return dict(
        bus_pd=case.bus_pd / base, gen_bus_onehot=cg, load_onehot=cd,
        load_pd=case.bus_pd[load_idx] / base, incidence=inc,
        b_susceptance=1.0 / case.br_x, br_rate=case.br_rate / base,
        gen_pmax=case.gen_pmax / base, gen_pmin=case.gen_pmin / base,
        unavail=u, mttf=mt[:, 0], mttr=mt[:, 1], always_up_nsq=always_up,
        ptdf=ptdf, lodf=lodf, br_transfer=a,
        theta_bound=2.0 * dist + 0.5)


def _to_device(arrays: dict, device, meta: dict) -> System:
    def dev(name, a):
        a = np.asarray(a)
        dt = torch.bool if name == "always_up_nsq" else torch.float32
        # Cast on the host (float64 -> float32 rounding, as jnp.asarray
        # does), then move once.
        return torch.as_tensor(a.astype(np.bool_ if dt is torch.bool
                                        else np.float32)).to(device)
    return System(**{k: dev(k, arrays[k]) for k in _TENSOR_FIELDS}, **meta)


def build_system(case: CaseData, compat: CompatFlags = CompatFlags(),
                 device: torch.device | str = "cuda") -> System:
    """Compile raw case data into a ``System`` on ``device`` (the card
    unless the caller passes ``device="cpu"``); mirrors reference
    ``core/system.py::build_system``."""
    arrays = _host_arrays(case, compat)
    meta = dict(name=case.name, n_bus=case.n_bus, n_gen=case.n_gen,
                n_branch=case.n_branch,
                n_load=int(arrays["load_pd"].shape[0]),
                base_mva=float(case.base_mva))
    return _to_device(arrays, torch.device(device), meta)


def from_reference(ref_system, device: torch.device | str = "cuda"
                   ) -> System:
    """The port's ``System`` holding exactly the values of a reference
    (JAX) ``System``: each field is read as a numpy array, so both
    packages compute on identical data. Used by the parity tests, which
    pass ``device="cpu"``; like every entry point it defaults to the
    card."""
    arrays = {k: np.asarray(getattr(ref_system, k)) for k in _TENSOR_FIELDS}
    meta = dict(name=ref_system.name, n_bus=int(ref_system.n_bus),
                n_gen=int(ref_system.n_gen),
                n_branch=int(ref_system.n_branch),
                n_load=int(ref_system.n_load),
                base_mva=float(ref_system.base_mva))
    return _to_device(arrays, torch.device(device), meta)
