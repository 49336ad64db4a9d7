// Shared device helpers for the port's hand-written Hopper kernels: the
// pivot-floored right-looking Cholesky batched_chol.cu factors with (its
// arithmetic is the one ipm_fused.cu's factor keeps), NaN-propagating
// min/max in the semantics of jnp.maximum / jnp.clip, and warp
// reductions.
//
// Replaces: the factorization step shared by the TPU Pallas kernels
//   powersystemsreliabilityassessment_tpu/ops/batched_chol.py
//   (_chol_kernel, PIVOT_FLOOR) and ops/ipm_fused.py (chol_step).
//
// What bounds it on an H100: each of the m factorization steps depends
// on the previous one, so a factorization is a chain of m block-wide
// barriers with O(m^2) shared-memory work between them; latency, not
// flops or bytes.
//
// What the design does about it: the matrix stays in shared memory for
// the whole chain, each step's trailing update is spread over all of
// the block's threads, and a step costs two barriers.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace psra {

// Largest LP row count the small-m kernels take (reference
// _PALLAS_MAX_M / _FUSED_MAX_M = 72); sizes the static shared arrays.
constexpr int MAXM = 72;

// Per-lane pivot floor of the reference (ops/batched_chol.py:41): the
// matrices are equilibrated to a unit diagonal, so a smaller pivot means
// f32 cancellation destroyed positive definiteness; flooring keeps the
// factor bounded and lets the caller's quality guard decide the lane.
constexpr float PIVOT_FLOOR = 1e-6f;

// max(v, lo) that keeps a NaN v (jnp.maximum semantics; fmaxf would drop
// it and hide a blown-up lane from the isfinite freeze).
__device__ __forceinline__ float nmax(float v, float lo) {
  return v < lo ? lo : v;
}

// min(v, hi) that keeps a NaN v.
__device__ __forceinline__ float nmin(float v, float hi) {
  return v > hi ? hi : v;
}

// clip(v, lo, hi) = min(max(v, lo), hi), NaN-propagating like jnp.clip.
__device__ __forceinline__ float nclip(float v, float lo, float hi) {
  return nmin(nmax(v, lo), hi);
}

enum ReduceOp { kSum = 0, kMin = 1, kMax = 2 };

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == kSum) return a + b;
  if (OP == kMin) return fminf(a, b);
  return fmaxf(a, b);
}

template <int OP>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = combine<OP>(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// In-place right-looking Cholesky of the m x m row-major matrix `a`
// (leading dimension lda) in shared memory, by the whole block. Same
// arithmetic as the reference kernel (ops/batched_chol.py::_chol_kernel):
// at step k, inv = rsqrt(max(a_kk, PIVOT_FLOOR)), the trailing square
// i, j > k takes a_ij -= (a_ik inv)(a_kj inv) (pivot row read from the
// upper triangle, as the reference does), then column k is scaled by inv.
// On return the lower triangle holds L; the strict upper triangle holds
// stale values the callers never read (batched_chol.cu zeroes it).
__device__ inline void chol_inplace(float* a, int m, int lda) {
  for (int k = 0; k < m; ++k) {
    __syncthreads();
    const float inv = rsqrtf(nmax(a[k * lda + k], PIVOT_FLOOR));
    const int r = m - k - 1;
    for (int t = threadIdx.x; t < r * r; t += blockDim.x) {
      const int i = k + 1 + t / r;
      const int j = k + 1 + t % r;
      a[i * lda + j] -= (a[i * lda + k] * inv) * (a[k * lda + j] * inv);
    }
    __syncthreads();
    for (int i = k + threadIdx.x; i < m; i += blockDim.x) a[i * lda + k] *= inv;
  }
  __syncthreads();
}

}  // namespace psra
