// Shared device helpers for the port's hand-written Hopper kernels:
// the constants of the reference's small-m kernels (MAXM, PIVOT_FLOOR),
// NaN-propagating min/max in the semantics of jnp.maximum / jnp.clip,
// and warp reductions.
//
// Replaces: the constants and helpers the TPU Pallas kernels share,
//   powersystemsreliabilityassessment_tpu/ops/batched_chol.py
//   (PIVOT_FLOOR, _PALLAS_MAX_M) and ops/ipm_fused.py (chol_step's
//   floor, its reductions).
//
// What bounds it on an H100, and what the design does about it: these
// are inline register operations (a compare and select, a five-step
// shuffle butterfly); each kernel's own note says what bounds it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace psra {

// Largest LP row count the small-m kernels take (reference
// _PALLAS_MAX_M / _FUSED_MAX_M = 72).
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

}  // namespace psra
