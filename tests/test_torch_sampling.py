"""PyTorch port: the plain Monte Carlo state sampler. Torch's generators
cannot reproduce JAX's threefry stream, so the sampler is held to its
distribution (Bernoulli marginals, the pinned synchronous condenser) and
to determinism in (seed, batch index), not to the reference's bits."""
import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
    sample_states)
from powersystemsreliabilityassessment_tpu_torch.studies.hl2_nsq import (
    batch_generator)

SYS = build_system(cases.rts24(), device="cpu")


def test_bernoulli_marginals_within_5_sigma():
    B = 65536
    down = sample_states(batch_generator(0, 0, "cpu"), SYS.unavail,
                         SYS.always_up_nsq, B)
    assert down.shape == (B, SYS.n_comp) and down.dtype == torch.bool
    u = SYS.unavail.double().numpy()
    u = np.where(SYS.always_up_nsq.numpy(), 0.0, u)
    freq = down.double().mean(0).numpy()
    sd = np.sqrt(u * (1 - u) / B)
    # 5 sd per component: a false alarm over 71 components has
    # probability ~4e-5; components with U = 0 must never fail.
    assert np.all(np.abs(freq - u) <= 5 * sd + 1e-12)


def test_sync_condenser_never_fails():
    # Boost every rate to 0.5 so an unpinned component 14 would fail in
    # about half of the lanes.
    boosted = torch.full_like(SYS.unavail, 0.5)
    down = sample_states(batch_generator(3, 0, "cpu"), boosted,
                         SYS.always_up_nsq, 8192)
    assert SYS.always_up_nsq.nonzero().flatten().tolist() == [14]
    assert not bool(down[:, 14].any())
    assert 0.45 < float(down[:, 15].double().mean()) < 0.55


def test_batches_are_deterministic_in_seed_and_index():
    draw = lambda s, i: sample_states(batch_generator(s, i, "cpu"),
                                      SYS.unavail, SYS.always_up_nsq, 4096)
    assert torch.equal(draw(0, 7), draw(0, 7))
    assert not torch.equal(draw(0, 7), draw(0, 8))
    assert not torch.equal(draw(0, 7), draw(1, 7))
