"""The LP route by m (``lp_ipm_batched.lp_route``) end to end, on the CPU.

``dcopf.evaluate_states_screened`` on fixed seeded states of each route
gives the bits it gave before the route table was added (``DIGESTS``,
recorded from that code with one intra-op thread: ``python -m
tests.test_torch_lp_route`` prints them anew):

* ``rts24_seq`` (m = 62, structured: K1's plain version, the polish and
  the warm rescue, five lanes written back): an RTS-24 SEQ block of two
  672-hour years at 1.4 times the load, 64 LP lanes.
* ``rts96`` (m = 191, blocked Cholesky and the rescue of every lane past
  the guard, seven of them): 64 stressed RTS-96 states, 16 LP lanes.
* ``case300s`` (m = 792, large: tier 1.5, the block-Schur pass at four
  iterations, so that the rescue ladder's stages and the escalation
  run): 64 stressed case300s states, 8 LP lanes.
"""
import hashlib

import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu_torch.core import (
    cases, load_profile)
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.sampling import (
    chronological)
from powersystemsreliabilityassessment_tpu_torch.studies import (
    hl2_nsq, hl2_seq)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

DIGESTS = {
    "case300s": "4340f30c7aa18d6d2ce1b8b77e855d56e6311618ff043f26ed72bb02befabaaf",
    "rts24_seq": "93a09dfddbbe6f41ca0c60da8d2e48d933394a184b2d410a5ea385a6eac05022",
    "rts96": "aac7529a37d13833c5966b11ca892655eb945457ec333f1c89606f5f548d2a16",
}
# Lanes of the RTS-96 draw that the blocked pass leaves past the guard
# (tests/test_torch_blocked_rescue.py's HARD).
HARD96 = [0, 89, 136, 138, 145, 172, 177, 230, 240, 244]


def _seq_block(sys_, years=2, hours=672, seed=2026):
    """``years`` years of ``hours`` hours of the SEQ sampler as the
    study's step hands them to the screened evaluator."""
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    load = hl2_seq.year_block_load(sys_, load_profile.load_factors(hours),
                                   years)
    down = hl2_seq.sample_years(
        hl2_nsq.batch_generator(seed, 0, sys_.device), sys_, years, hours,
        k).transpose(1, 2).reshape(years * hours, -1)
    return down, load


def _stressed(case, sys_, n, seed, boost, load_lo):
    """``n`` states at ``boost`` x unavailability (pinned units up) and
    loads at a uniform share in [``load_lo``, 1] of the peak."""
    rng = np.random.default_rng(seed)
    q = twostate.unavailability(case)
    down = rng.uniform(size=(n, sys_.n_comp)) < boost * q[None, :]
    down[:, sys_.always_up_nsq.numpy()] = False
    share = rng.uniform(load_lo, 1.0, (n, 1))
    load = sys_.load_pd[None, :] * torch.as_tensor(share, dtype=torch.float32)
    return torch.as_tensor(down), load


def _run(name):
    """The screened evaluator's outputs on route ``name``'s states."""
    case = {"rts24_seq": cases.rts24, "rts96": cases.rts96,
            "case300s": cases.case300s}[name]()
    sys_ = build_system(case, device="cpu")
    if name == "rts24_seq":
        down, load = _seq_block(sys_)
        load = 1.4 * load
        kw = dict(max_lp=64, repair_buffer=256)
    elif name == "rts96":
        down, load = _stressed(case, sys_, 256, seed=7, boost=4.0,
                               load_lo=0.7)
        lanes = torch.as_tensor(HARD96 + list(range(1, 55)))
        down, load = down[lanes], load[lanes]
        kw = dict(max_lp=16, woodbury_k=4)
    else:
        down, load = _stressed(case, sys_, 64, seed=12, boost=8.0,
                               load_lo=0.9)
        kw = dict(max_lp=8, pf_buffer=dcopf.default_pf_buffer(sys_, 64),
                  ipm=IPMConfig(iterations=4, rescue_iterations=4))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the digests' thread count
    try:
        res, n_over = dcopf.evaluate_states_screened(sys_, down, load, **kw)
    finally:
        torch.set_num_threads(threads)
    return res, n_over


def _digest(name) -> str:
    res, n_over = _run(name)
    h = hashlib.sha256()
    for t in list(res) + [n_over]:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_each_route_keeps_its_bits(name):
    assert _digest(name) == DIGESTS[name]


if __name__ == "__main__":
    for name in ("case300s", "rts24_seq", "rts96"):
        print(f'    "{name}": "{_digest(name)}",')
