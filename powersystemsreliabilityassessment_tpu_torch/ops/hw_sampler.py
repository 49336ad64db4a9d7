"""Bernoulli outage sampler with an in-kernel generator (K6).

Port of ``powersystemsreliabilityassessment_tpu/ops/hw_sampler.py``
(``bernoulli_thresholds``, ``sample_states_hw``). The reference draws
24-bit words from the TPU core's hardware PRNG; the port draws them from
Philox4x32-10, a counter-based generator, inside the kernel of
``csrc/hw_sampler.cu``:

* key = two 32-bit seed words, drawn from the batch's ``torch.Generator``
  as an int32 [2] tensor on the device (``seed_words``) and read by the
  kernel through a pointer, so nothing waits for the device;
* counter = (row, call, 0, 0); call j yields four words, one for each of
  components 4j .. 4j + 3;
* component i fails iff ``word >> 8`` (24 random bits) is below
  ``ceil(U_i 2^24)`` (``bernoulli_thresholds``); pinned components get
  threshold 0 and never fail.

A row's states depend only on the seed words and the row index, so the
fused sampler-certificate kernel (``ops/fused_sampler_cert.py``) draws
exactly these states, and a batch redrawn from the same generator is the
same batch. The stream differs from the default sampler's (and from the
reference's hardware bits); the Bernoulli law is the same.

``sample_states_hw`` is the wrapper: on a CUDA tensor it launches the
kernel (or raises); on a CPU tensor it runs ``sample_states_hw_plain``,
the same Philox in plain PyTorch integer arithmetic, bit for bit.
``launches`` counts kernel launches. The reference's 128-column padding
is not ported: the kernel writes the bool [B, n_comp] the caller uses.
"""
from __future__ import annotations

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import cuda_build

BITS = 24
_SCALE = float(1 << BITS)
# Philox4x32 round multipliers and key increments (Random123).
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF

launches = {"sample_states_hw": 0}


def bernoulli_thresholds(unavail: torch.Tensor,
                         always_up: torch.Tensor) -> torch.Tensor:
    """int32 [n_comp] thresholds: P(fail) = ceil(U 2^24) / 2^24.

    Bit-equal to reference ``ops/hw_sampler.py::bernoulli_thresholds``
    without its padding: ``ceil`` in float32 keeps P(fail) > 0 for every
    U > 0, the result is clipped to [0, 2^24], and pinned components get 0
    (a 24-bit draw is never < 0)."""
    t = torch.ceil(unavail.to(torch.float32) * _SCALE).to(torch.int32)
    t = torch.clamp(t, 0, 1 << BITS)
    return torch.where(always_up, 0, t).to(torch.int32)


def seed_words(generator: torch.Generator,
               device: torch.device | str) -> torch.Tensor:
    """The Philox key of one batch: int32 [2] drawn from ``generator`` on
    ``device`` (the generator's), so a CUDA key is never read on the
    host."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         generator=generator, device=device)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for uint32 values a held in int64
    and a constant m < 2^32. a * m reaches 2^64 and overflows int64, so
    m is split into 16-bit halves: each partial product is < 2^48."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    low_sum = p_lo + ((p_hi & 0xFFFF) << 16)          # < 2^49
    return (p_hi >> 16) + (low_sum >> 32), low_sum & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 in plain PyTorch: ``counter`` is four int64 tensors
    of uint32 values (broadcastable), ``key`` two; returns the four
    output words, as csrc/philox.cuh computes them."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd > 0:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def draws24(seeds: torch.Tensor, batch: int, n_comp: int) -> torch.Tensor:
    """int64 [batch, n_comp] 24-bit draws of rows 0 .. batch - 1 under
    key ``seeds`` (int32 [2]): counter (row, call, 0, 0), word q of call j
    for component 4j + q."""
    dev = seeds.device
    key = seeds.to(torch.int64) & _MASK32
    n_calls = -(-n_comp // 4)
    row = torch.arange(batch, dtype=torch.int64, device=dev)[:, None]
    call = torch.arange(n_calls, dtype=torch.int64, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32_10((row, call, zero, zero), (key[0], key[1]))
    words = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return (words.reshape(batch, 4 * n_calls)[:, :n_comp] >> (32 - BITS))


def sample_states_hw_plain(seeds: torch.Tensor, thresh: torch.Tensor,
                           batch: int) -> torch.Tensor:
    """Plain PyTorch version of the K6 kernel: bool [batch, n_comp],
    component i failed iff its draw is below ``thresh[i]``."""
    return draws24(seeds, batch, thresh.shape[0]) < thresh[None, :]


def launch(seeds: torch.Tensor, thresh: torch.Tensor,
           batch: int) -> torch.Tensor:
    """One K6 launch: bool [batch, n_comp] under key ``seeds``."""
    for name, t, n in (("seeds", seeds, 2), ("thresh", thresh, None)):
        if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous() or (n and t.shape[0] != n):
            raise ValueError(f"sample_states_hw: {name} must be a "
                             f"contiguous 1-d int32 CUDA tensor")
    if seeds.device != thresh.device:
        raise ValueError("sample_states_hw: seeds and thresh are on "
                         "different devices")
    out = torch.empty((batch, thresh.shape[0]), dtype=torch.bool,
                      device=thresh.device)
    err = cuda_build.library().psra_bernoulli(
        seeds.data_ptr(), thresh.data_ptr(), out.data_ptr(), batch,
        thresh.shape[0], cuda_build.stream_handle(out))
    cuda_build.check_launch(err, "sample_states_hw")
    launches["sample_states_hw"] += 1
    return out


def sample_states_hw(generator: torch.Generator, unavail: torch.Tensor,
                     always_up: torch.Tensor, batch: int) -> torch.Tensor:
    """Draw ``batch`` component-failure indicators (True = failed) with
    the K6 sampler; mirrors reference ``ops/hw_sampler.py::
    sample_states_hw``. The key comes from ``generator`` (on
    ``unavail``'s device). CUDA: the K6 kernel; CPU:
    :func:`sample_states_hw_plain`. Returns bool [batch, n_comp]."""
    seeds = seed_words(generator, unavail.device)
    thresh = bernoulli_thresholds(unavail, always_up)
    if unavail.device.type == "cpu":
        return sample_states_hw_plain(seeds, thresh, batch)
    return launch(seeds, thresh, batch)
