"""PyTorch port: the K6 Bernoulli sampler (``ops/hw_sampler.py``) on the
CPU, where it runs its plain version.

* Thresholds bit-equal to the reference's ``bernoulli_thresholds``.
* The plain Philox4x32-10 against the Random123 known-answer vectors, so
  the CUDA kernel (held bit-equal to this plain version on the card by
  tests/test_torch_gpu.py and chip_smoke.py) draws the published
  generator's bits.
* The Bernoulli law: marginals within 5 sigma, pinned components never
  fail; a row's states depend only on the seed words and the row.
* ``sample_states(rng_impl="hw")`` reaches the sampler; an unknown
  ``rng_impl`` raises, as in the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.ops import (
    hw_sampler as ref_hw_sampler)

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.ops import hw_sampler
from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
    sample_states)
from powersystemsreliabilityassessment_tpu_torch.studies.hl2_nsq import (
    batch_generator)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SYS = build_system(cases.rts24(), device="cpu")

# Random123's known-answer vectors for Philox4x32-10 (kat_vectors):
# (counter, key) -> output words.
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def test_thresholds_bit_equal_to_reference():
    u = np.array([0.0, 1e-9, 0.02, 0.5, 1.0, 0.3, 2.0 ** -25, 0.0999],
                 np.float32)
    pinned = np.array([False, False, False, False, False, True, False,
                       False])
    ref = np.asarray(ref_hw_sampler.bernoulli_thresholds(
        jnp.asarray(u), jnp.asarray(pinned), 128))[0, :u.shape[0]]
    got = hw_sampler.bernoulli_thresholds(torch.as_tensor(u),
                                          torch.as_tensor(pinned))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[1] == 1 and got[4] == 1 << 24 and got[5] == 0


@pytest.mark.parametrize("counter,key,words", KAT)
def test_philox_known_answers(counter, key, words):
    t = lambda v: tuple(torch.tensor(x, dtype=torch.int64) for x in v)
    got = hw_sampler.philox4x32_10(t(counter), t(key))
    assert tuple(int(w) for w in got) == words


def test_marginals_within_5_sigma_and_pin():
    B = 1 << 16
    down = hw_sampler.sample_states_hw(batch_generator(0, 0, "cpu"),
                                       SYS.unavail, SYS.always_up_nsq, B)
    assert down.shape == (B, SYS.n_comp) and down.dtype == torch.bool
    pinned = SYS.always_up_nsq.numpy()
    assert not down[:, pinned].any()
    # The law the thresholds quantize to: ceil(U 2^24) / 2^24.
    p = hw_sampler.bernoulli_thresholds(
        SYS.unavail, SYS.always_up_nsq).double().numpy() / 2.0 ** 24
    freq = down.double().mean(0).numpy()
    sd = np.sqrt(p * (1 - p) / B)
    assert np.all(np.abs(freq - p) <= 5 * sd + 1e-12)
    # An unpinned rate of 0.5 fails in about half of the rows.
    half = hw_sampler.sample_states_hw(
        batch_generator(3, 0, "cpu"), torch.full_like(SYS.unavail, 0.5),
        SYS.always_up_nsq, 8192)
    assert not half[:, 14].any()
    assert 0.45 < float(half[:, 15].double().mean()) < 0.55


def test_rows_depend_only_on_seed_words_and_row():
    seeds = torch.tensor([123, -456], dtype=torch.int32)
    thresh = hw_sampler.bernoulli_thresholds(SYS.unavail, SYS.always_up_nsq)
    small = hw_sampler.sample_states_hw_plain(seeds, thresh, 100)
    big = hw_sampler.sample_states_hw_plain(seeds, thresh, 3000)
    assert torch.equal(small, big[:100])
    draws = hw_sampler.draws24(seeds, 3000, SYS.n_comp)
    assert int(draws.min()) >= 0 and int(draws.max()) < 1 << 24
    other = hw_sampler.sample_states_hw_plain(
        torch.tensor([123, -455], dtype=torch.int32), thresh, 3000)
    assert not torch.equal(big, other)


def test_sample_states_rng_impl():
    hw = sample_states(batch_generator(0, 5, "cpu"), SYS.unavail,
                       SYS.always_up_nsq, 4096, rng_impl="hw")
    direct = hw_sampler.sample_states_hw(batch_generator(0, 5, "cpu"),
                                         SYS.unavail, SYS.always_up_nsq,
                                         4096)
    assert torch.equal(hw, direct)
    default = sample_states(batch_generator(0, 5, "cpu"), SYS.unavail,
                            SYS.always_up_nsq, 4096)
    assert not torch.equal(hw, default)     # another stream
    with pytest.raises(ValueError, match="rng_impl"):
        sample_states(batch_generator(0, 5, "cpu"), SYS.unavail,
                      SYS.always_up_nsq, 16, rng_impl="threefry2")
