// Bernoulli outage sampler with an in-kernel counter-based generator
// (K6): out[b, i] = 1 iff component i of state b fails.
//
// Replaces: the TPU Pallas kernel of
//   powersystemsreliabilityassessment_tpu/ops/hw_sampler.py —
//   sample_states_hw (body _kernel), which draws 24-bit words from the
//   TPU core's hardware PRNG into a [TILE, 128] uint8 block. Here the
//   words come from Philox4x32-10 (philox.cuh) keyed by two seed words
//   read from device memory, so the wrapper never reads them on the
//   host, and the output is the unpadded bool [B, n_comp].
//
// What bounds it on an H100: its integer work, ten Philox rounds per
// four draws, ~106 32-bit operations a call (chip_smoke.py
// PHILOX_CALL_OPS): ~7.5 us at B = 262144, n_comp = 71, counted at the
// float32 rate of 67 TFLOP/s. The bytes it writes, B * n_comp (18.6 MB:
// ~5.6 us at 3.35 TB/s), are the second limit.
//
// What the design does about it: one thread per (row, call): it runs
// one Philox call and writes the row's four neighbouring bytes, so
// neighbouring threads write neighbouring bytes of the row-major output
// and every store of a warp falls in one or two 128-byte segments. No
// shared memory, no synchronisation; the thresholds (<= 128 ints) stay
// in the read-only cache.

#include <stdint.h>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace psra {

constexpr int SAMPLER_THREADS = 256;

__global__ void __launch_bounds__(SAMPLER_THREADS)
bernoulli_kernel(const int* __restrict__ seeds,
                 const int* __restrict__ thresh,
                 unsigned char* __restrict__ out, int batch, int n_comp,
                 int n_calls) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)batch * n_calls) return;
  const uint32_t row = (uint32_t)(t / n_calls);
  const uint32_t call = (uint32_t)(t % n_calls);
  unsigned char fail[4];
  bernoulli4(seeds, thresh, n_comp, row, call, fail);
  unsigned char* dst = out + (size_t)row * n_comp + 4 * call;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (4 * (int)call + q < n_comp) dst[q] = fail[q];
}

}  // namespace psra

// C interface (bound with ctypes). seeds: int32 [2] on the device;
// thresh: int32 [n_comp]; out: bool (one byte) [batch, n_comp]. Launches
// on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int psra_bernoulli(const int* seeds, const int* thresh,
                              unsigned char* out, int batch, int n_comp,
                              void* stream) {
  const int n_calls = (n_comp + 3) / 4;
  const size_t threads = (size_t)batch * n_calls;
  const size_t blocks =
      (threads + psra::SAMPLER_THREADS - 1) / psra::SAMPLER_THREADS;
  if (threads > 0)
    psra::bernoulli_kernel<<<(unsigned)blocks, psra::SAMPLER_THREADS, 0,
                             (cudaStream_t)stream>>>(seeds, thresh, out,
                                                     batch, n_comp, n_calls);
  return (int)cudaGetLastError();
}
