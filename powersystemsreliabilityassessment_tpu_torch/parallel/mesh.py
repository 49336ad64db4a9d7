"""The scenario mesh: the scenario axis is the data-parallel axis.

Port of ``powersystemsreliabilityassessment_tpu/parallel/mesh.py``. The
reference shards the scenario axis of every Monte Carlo engine over a
1-D ``jax.sharding.Mesh`` of all its devices and ``psum``s the index
partials across it. Here the mesh is ``torch.distributed``: one process
per device (a GPU's launches then never share a host thread with
another GPU's), each drawing its own scenarios and issuing one
``all_reduce`` of its packed partials a step. Scenarios are i.i.d., so
the mesh is one-dimensional, as in the reference.

Run a study on N cards of one host with torchrun::

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m powersystemsreliabilityassessment_tpu_torch nsq ...

``init_from_env`` initialises the process group from torchrun's
variables (NCCL for a card, gloo for the CPU) and ``scenario_mesh``
builds the mesh on ``cuda:LOCAL_RANK``. Without a process group the
mesh has one member and no group: every collective here is then a no-op
and a study returns what it returns without a mesh. A group of one
member (``world_size=1``) does issue its collectives, so the real
``all_reduce`` can be measured in the real step on one card.

The reference's ``warmup_backend`` (the TPU relay's admission stall) has
no counterpart here.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

SCENARIO_AXIS = "scenarios"

# A rank that dies makes the others fail within this, not hang.
TIMEOUT = datetime.timedelta(seconds=60)


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """The scenario axis as seen from one process: its device, its rank,
    the number of ranks and the process group (None for a one-member
    mesh without a process group)."""
    device: torch.device
    rank: int = 0
    size: int = 1
    group: object = None


def one_device(device: torch.device | str) -> ScenarioMesh:
    """A one-member mesh on ``device`` with no group: what a study runs
    on when it is given no mesh."""
    return ScenarioMesh(torch.device(device))


def local_device(device: torch.device | str = "cuda") -> torch.device:
    """``device``, with a bare ``"cuda"`` read as ``cuda:LOCAL_RANK``
    (torchrun's local rank, 0 outside torchrun)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def default_backend(device: torch.device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _check_backend(device: torch.device, backend: str) -> None:
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
            if local > cards:
                raise RuntimeError(
                    f"NCCL needs a card for each rank: {local} local ranks, "
                    f"{cards} card(s). Ranks share a card only over gloo "
                    "(backend='gloo' with an explicit device such as "
                    "cuda:0).")
        if device.index is not None and device.index >= cards:
            raise RuntimeError(
                f"{device} does not exist ({cards} card(s)); ranks that "
                "share a card name it (cuda:0) and use gloo")
    elif backend == "nccl":
        raise RuntimeError(f"NCCL runs on cards, not on {device}")


def init_from_env(device: torch.device | str = "cuda",
                  backend: str | None = None) -> bool:
    """Initialise the default process group from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) when
    ``WORLD_SIZE`` is above 1; returns whether it did. The backend is
    ``backend``, else NCCL for a card and gloo for the CPU; the wait on
    a peer is bounded by :data:`TIMEOUT`. Takes the place of the
    reference's implicit multi-host JAX start-up."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    dev = local_device(device)
    backend = backend or default_backend(dev)
    _check_backend(dev, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=TIMEOUT)
    return True


def scenario_mesh(device: torch.device | str = "cuda",
                  backend: str | None = None) -> ScenarioMesh:
    """The mesh of every rank of the default process group on
    ``local_device(device)``; mirrors reference
    ``parallel/mesh.py::scenario_mesh``. Without an initialised process
    group, a one-member mesh on ``device`` (:func:`one_device`).
    ``backend`` (None: NCCL for a card, gloo for the CPU) must be the
    group's; NCCL with more local ranks than cards raises."""
    if not (dist.is_available() and dist.is_initialized()):
        return one_device(device)
    dev = local_device(device)
    want = backend or default_backend(dev)
    have = dist.get_backend()
    if want != have:
        raise RuntimeError(f"the process group runs {have}, not {want}; "
                           "pass backend= to match it")
    _check_backend(dev, want)
    return ScenarioMesh(dev, dist.get_rank(), dist.get_world_size(),
                        dist.group.WORLD)


def psum(mesh: ScenarioMesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the mesh in place (one ``all_reduce``) and return
    it; mirrors the reference's ``jax.lax.psum(t, SCENARIO_AXIS)``. No-op
    on a mesh without a group."""
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def shard_batch(mesh: ScenarioMesh, tensor: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of ``tensor``'s leading axis, on the
    mesh's device; mirrors reference ``parallel/mesh.py::shard_batch``
    (a leading axis the mesh does not divide raises, as a
    ``NamedSharding`` does)."""
    n = tensor.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} is not a multiple of the "
                         f"mesh's {mesh.size} ranks")
    k = n // mesh.size
    return tensor[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device)


def replicated(mesh: ScenarioMesh, tensor: torch.Tensor,
               src: int = 0) -> torch.Tensor:
    """A copy of ``tensor`` on the mesh's device holding rank ``src``'s
    values on every rank (a broadcast; a copy alone without a group);
    mirrors reference ``parallel/mesh.py::replicated``. Every rank passes
    a tensor of the same shape and dtype."""
    t = tensor.to(mesh.device, copy=True).contiguous()
    if mesh.group is not None:
        dist.broadcast(t, src=src, group=mesh.group)
    return t


def from_rank0(mesh: ScenarioMesh, compute, size: int):
    """``compute()``'s result on rank 0 (a float vector of ``size``
    values, or None), given to every rank through :func:`replicated` as
    float64 numpy; without a group ``compute()``'s own result, untouched.
    For the pre-passes the reference does not shard (the shed hint, the
    CE pilot, the enumeration, the control variate's means, the
    splitting level): every rank then folds the same numbers. Every rank
    runs ``compute`` (on its own device: no wall time lost), so the
    ranks reach the broadcast together; a pre-pass run on rank 0 alone
    would keep the others waiting at the broadcast, and one longer than
    :data:`TIMEOUT` (an enumeration, a CE pilot on a large case) would
    fail them."""
    value = compute()
    if mesh.group is None:
        return value
    buf = torch.zeros(size + 1, dtype=torch.float64)
    if value is not None:
        buf[0] = 1.0
        buf[1:] = torch.as_tensor(np.asarray(value, np.float64).reshape(-1))
    out = replicated(mesh, buf).cpu().numpy()
    return out[1:] if out[0] else None


def slot(mesh: ScenarioMesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` ``[..., n]`` placed in this rank's slot of zeros ``[...,
    size n]``: summed over the mesh (:func:`psum`), the slots give the
    reference's ``all_gather(t, tiled=True)`` along the last axis, in
    rank order and exactly (x + 0 = x), with the same single collective
    as every other partial."""
    if mesh.size == 1:
        return t
    out = t.new_zeros(*t.shape[:-1], mesh.size, t.shape[-1])
    out[..., mesh.rank, :] = t
    return out.reshape(*t.shape[:-1], mesh.size * t.shape[-1])


__all__ = ["SCENARIO_AXIS", "ScenarioMesh", "TIMEOUT", "default_backend",
           "from_rank0", "init_from_env", "local_device", "one_device",
           "psum", "replicated", "scenario_mesh", "shard_batch", "slot"]
