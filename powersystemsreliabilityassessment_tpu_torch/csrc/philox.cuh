// Philox4x32-10 (Salmon, Moraes, Dror, Shaw, "Parallel random numbers:
// as easy as 1, 2, 3", SC 2011; the Random123 constants), and the
// Bernoulli draw rule of the reference's hardware-PRNG sampler.
//
// Replaces: the TPU core's hardware PRNG (pltpu.prng_seed /
//   prng_random_bits) that the Pallas kernels of
//   powersystemsreliabilityassessment_tpu/ops/hw_sampler.py and
//   ops/fused_sampler_cert.py draw from. A counter-based generator gives
//   each (row, word) its own bits, so a row's states depend only on the
//   two key words and the row index: not on tiling, grid or batch size.
//
// Layout shared by every kernel and plain version of the port: key =
// the two seed words, counter = (row, call, 0, 0); call j yields four
// 32-bit words, one per component 4j .. 4j + 3. Component i fails iff
// (word >> 8) < thresh[i] (24 random bits, as the reference's
// shift_right_logical(bits, 8)).
#pragma once

#include <stdint.h>

namespace psra {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;
constexpr int DRAW_SHIFT = 8;   // 32 - 24 random bits per draw

// Ten rounds of Philox4x32 on counter c with key (k0, k1); c is
// overwritten with the four output words.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c[0]), lo0 = PHILOX_M0 * c[0];
    const uint32_t hi1 = __umulhi(PHILOX_M1, c[2]), lo1 = PHILOX_M1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// The four outage draws of call `call` of row `row`: out[q] = 1 iff
// component 4 call + q (< n_comp) fails. Components past n_comp get 0.
__device__ __forceinline__ void bernoulli4(const int* seeds,
                                           const int* thresh, int n_comp,
                                           uint32_t row, uint32_t call,
                                           unsigned char out[4]) {
  uint32_t c[4] = {row, call, 0u, 0u};
  philox4x32_10(c, (uint32_t)seeds[0], (uint32_t)seeds[1]);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * (int)call + q;
    out[q] = i < n_comp && (int)(c[q] >> DRAW_SHIFT) < thresh[i];
  }
}

}  // namespace psra
