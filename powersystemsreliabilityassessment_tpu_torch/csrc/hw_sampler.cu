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
// What the design does about it: a block takes a tile of R rows (R a
// multiple of 16 with R * n_comp near 16 KB: 224 rows at n_comp = 71),
// one contiguous, 16-byte aligned span of R * n_comp output bytes. Its
// threads run the tile's (row, call) Philox calls with 32-bit indices
// that advance by a stride fixed once (no division in the loop), with
// the thresholds in shared memory (a call's four in one 16-byte load)
// and the key in registers; each call's four bytes go into the tile's
// image in shared memory, and the block
// stores the span with aligned 16-byte pieces (single bytes only at a
// ragged end). The bits are the counter's: (row, call) as before, so
// every tiling gives the same states.

#include <stdint.h>

#include <cuda_runtime.h>

#include "lane_common.cuh"
#include "philox.cuh"

namespace psra {

constexpr int SAMPLER_THREADS = 256;
constexpr int SAMPLER_TILE_BYTES = 16384;   // a tile's output bytes, about

// Rows a tile: a multiple of 16, so that every tile's span starts on a
// 16-byte boundary; at least 16.
__host__ __device__ __forceinline__ int sampler_rows(int n_comp) {
  const int r = (SAMPLER_TILE_BYTES / n_comp) & ~15;
  return r > 16 ? r : 16;
}

// Dynamic shared bytes: the thresholds (zero-padded to whole calls),
// then the tile's image.
__host__ __device__ __forceinline__ int sampler_smem(int n_comp) {
  return 4 * round4(n_comp) + sampler_rows(n_comp) * n_comp;
}

__global__ void __launch_bounds__(SAMPLER_THREADS)
bernoulli_kernel(const int* __restrict__ seeds,
                 const int* __restrict__ thresh,
                 unsigned char* __restrict__ out, int batch, int n_comp,
                 int n_calls) {
  extern __shared__ __align__(16) float smem[];
  int* th = reinterpret_cast<int*>(smem);   // [n_calls][4], zero-padded
  unsigned char* img = reinterpret_cast<unsigned char*>(smem + 4 * n_calls);
  for (int i = threadIdx.x; i < 4 * n_calls; i += blockDim.x)
    th[i] = i < n_comp ? thresh[i] : 0;
  const uint32_t k0 = (uint32_t)seeds[0], k1 = (uint32_t)seeds[1];
  const int tile_rows = sampler_rows(n_comp);
  // This thread's first (row, call) of a tile and the step to its next.
  const int step_r = SAMPLER_THREADS / n_calls;
  const int step_c = SAMPLER_THREADS - step_r * n_calls;
  const int r0 = threadIdx.x / n_calls, c0 = threadIdx.x - r0 * n_calls;
  __syncthreads();
  for (int b0 = blockIdx.x * tile_rows; b0 < batch;
       b0 += gridDim.x * tile_rows) {
    const int rows = min(tile_rows, batch - b0);
    for (int r = r0, c = c0; r < rows;) {
      // bernoulli4 of philox.cuh, with the call's four thresholds in one
      // 16-byte load and the bounds test only on a row's last call.
      uint32_t x[4] = {(uint32_t)(b0 + r), (uint32_t)c, 0u, 0u};
      philox4x32_10(x, k0, k1);
      const int4 t = reinterpret_cast<const int4*>(th)[c];
      const unsigned char f0 = (int)(x[0] >> DRAW_SHIFT) < t.x;
      const unsigned char f1 = (int)(x[1] >> DRAW_SHIFT) < t.y;
      const unsigned char f2 = (int)(x[2] >> DRAW_SHIFT) < t.z;
      const unsigned char f3 = (int)(x[3] >> DRAW_SHIFT) < t.w;
      unsigned char* dst = img + r * n_comp + 4 * c;
      const int left = n_comp - 4 * c;   // >= 1
      dst[0] = f0;
      if (left > 1) dst[1] = f1;
      if (left > 2) dst[2] = f2;
      if (left > 3) dst[3] = f3;
      r += step_r;
      c += step_c;
      if (c >= n_calls) {
        c -= n_calls;
        ++r;
      }
    }
    __syncthreads();
    block_copy(out + (size_t)b0 * n_comp, img, rows * n_comp);
    __syncthreads();   // the image is out before the next tile's draws
  }
}

}  // namespace psra

// C interface (bound with ctypes). seeds: int32 [2] on the device;
// thresh: int32 [n_comp]; out: bool (one byte) [batch, n_comp]. Launches
// on `stream`, allocates nothing, returns the first CUDA error.
extern "C" int psra_bernoulli(const int* seeds, const int* thresh,
                              unsigned char* out, int batch, int n_comp,
                              void* stream) {
  if (batch <= 0 || n_comp <= 0) return (int)cudaGetLastError();
  const int n_calls = (n_comp + 3) / 4;
  const int rows = psra::sampler_rows(n_comp);
  const int smem = psra::sampler_smem(n_comp);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        psra::bernoulli_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (batch + rows - 1) / rows;
  psra::bernoulli_kernel<<<tiles, psra::SAMPLER_THREADS, smem,
                           (cudaStream_t)stream>>>(seeds, thresh, out, batch,
                                                   n_comp, n_calls);
  return (int)cudaGetLastError();
}
