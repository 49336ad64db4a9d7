// Batched lower-triangular solves on one diagonal panel (K3): per lane b,
// X_b = L_b^-1 B_b (forward) or X_b = L_b^-T B_b (backward), L_b [P, P]
// lower triangular with P <= 64, B_b [P, K]; batch-major, float32.
//
// Replaces: the TPU Pallas kernels of
//   powersystemsreliabilityassessment_tpu/ops/blocked_chol.py —
//   trsm_fwd (_trsm_fwd_kernel) and trsm_bwd (_trsm_bwd_kernel), launched
//   by _call_trsm — which map 128 lanes onto the TPU's vector lanes
//   ("batch-minor") and walk the P rows in a fori_loop.
//
// What bounds it on an H100: the blocked Cholesky (ops/blocked_chol.py)
// calls it two ways. With K = 1 (the probe and every refined solve, ~72
// of the ~80 calls per IPM iteration at RTS-96's m = 191) a lane reads
// its L (up to 12.5 KB) once and does ~P^2 flops over P dependent rows:
// too little work for the bytes, and the rows form a chain, so the time
// is the step latency of P dependent dot products, not flops. With
// K = 56 (the off-diagonal blocks of the factor) a lane does ~P^2 K / 2
// FMAs on 3 x 12.5 KB of data, ~5 flops per byte: bytes bound it, well
// below the card's ~20 flops per byte of float32 balance (67 TFLOP/s
// over 3.35 TB/s).
//
// What the design does about it: one lane's L is staged in shared memory
// once, with an odd leading dimension so the backward solve's column
// reads hit distinct banks. K = 1: one warp per lane, each row a warp-
// shuffle reduction with no block-wide barrier (as cho_solve_kernel in
// batched_chol.cu). K > 1: one thread per right-hand-side column, up to
// 64 columns per block; the columns are independent, so the substitution
// over rows needs no barrier at all and device memory is touched once on
// the way in and once on the way out.

#include "common.cuh"

namespace psra {

constexpr int TRSM_MAXP = 64;       // widest panel (blocked_chol.PANEL = 56)
constexpr int TRSM_COLS = 64;       // right-hand-side columns per block, K > 1
constexpr int TRSM_VEC_WARPS = 2;   // lanes per block, K = 1

// Copy lane b's row-major P x P factor into shared memory with leading
// dimension ld, by `nthreads` threads numbered `tid`.
__device__ __forceinline__ void stage_factor(const float* __restrict__ Lb,
                                             float* ls, int P, int ld,
                                             int tid, int nthreads) {
  for (int t = tid; t < P * P; t += nthreads) ls[(t / P) * ld + t % P] = Lb[t];
}

template <bool FWD>
__global__ void __launch_bounds__(TRSM_COLS)
trsm_cols_kernel(const float* __restrict__ L, const float* __restrict__ Bm,
                 float* __restrict__ X, int P, int K) {
  __shared__ float ls[TRSM_MAXP * (TRSM_MAXP | 1)];
  __shared__ float xs[TRSM_MAXP * TRSM_COLS];
  const int ld = P | 1;
  const int t = threadIdx.x;
  const int col = blockIdx.y * TRSM_COLS + t;
  const size_t lane = blockIdx.x;
  stage_factor(L + lane * P * P, ls, P, ld, t, blockDim.x);
  const float* Bb = Bm + lane * P * K;
  if (col < K)
    for (int i = 0; i < P; ++i) xs[i * TRSM_COLS + t] = Bb[(size_t)i * K + col];
  __syncthreads();
  if (col >= K) return;
  // Each thread reads and writes only its own column of xs from here on.
  if (FWD) {
    // x_i = (b_i - sum_{k<i} L_ik x_k) / L_ii
    for (int i = 0; i < P; ++i) {
      float s = 0.0f;
      for (int k = 0; k < i; ++k) s += ls[i * ld + k] * xs[k * TRSM_COLS + t];
      xs[i * TRSM_COLS + t] = (xs[i * TRSM_COLS + t] - s) / ls[i * ld + i];
    }
  } else {
    // x_i = (b_i - sum_{k>i} L_ki x_k) / L_ii
    for (int i = P - 1; i >= 0; --i) {
      float s = 0.0f;
      for (int k = i + 1; k < P; ++k) s += ls[k * ld + i] * xs[k * TRSM_COLS + t];
      xs[i * TRSM_COLS + t] = (xs[i * TRSM_COLS + t] - s) / ls[i * ld + i];
    }
  }
  float* Xb = X + lane * P * K;
  for (int i = 0; i < P; ++i) Xb[(size_t)i * K + col] = xs[i * TRSM_COLS + t];
}

template <bool FWD>
__global__ void __launch_bounds__(TRSM_VEC_WARPS * 32)
trsm_vec_kernel(const float* __restrict__ L, const float* __restrict__ r,
                float* __restrict__ x, int batch, int P) {
  __shared__ float ls[TRSM_VEC_WARPS][TRSM_MAXP * (TRSM_MAXP | 1)];
  __shared__ float ys[TRSM_VEC_WARPS][TRSM_MAXP];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * TRSM_VEC_WARPS + w;
  if (b >= batch) return;  // warp-uniform: only __syncwarp follows
  const int ld = P | 1;
  float* lw = ls[w];
  float* y = ys[w];
  stage_factor(L + (size_t)b * P * P, lw, P, ld, lane, 32);
  for (int t = lane; t < P; t += 32) y[t] = r[(size_t)b * P + t];
  __syncwarp();
  if (FWD) {
    for (int i = 0; i < P; ++i) {
      float s = 0.0f;
      for (int k = lane; k < i; k += 32) s += lw[i * ld + k] * y[k];
      s = warp_reduce<kSum>(s);
      if (lane == 0) y[i] = (y[i] - s) / lw[i * ld + i];
      __syncwarp();
    }
  } else {
    for (int i = P - 1; i >= 0; --i) {
      float s = 0.0f;
      for (int k = i + 1 + lane; k < P; k += 32) s += lw[k * ld + i] * y[k];
      s = warp_reduce<kSum>(s);
      if (lane == 0) y[i] = (y[i] - s) / lw[i * ld + i];
      __syncwarp();
    }
  }
  for (int t = lane; t < P; t += 32) x[(size_t)b * P + t] = y[t];
}

}  // namespace psra

// C interface (bound with ctypes). L [batch, P, P], B and X [batch, P, K]:
// device pointers of contiguous float32 tensors; the wrapper checks
// shapes. Launches on `stream`, allocates nothing and returns
// cudaGetLastError() (cudaErrorInvalidValue for P outside 1..64).
extern "C" int psra_trsm(const float* L, const float* B, float* X, int batch,
                         int P, int K, int forward, void* stream) {
  if (P < 1 || P > psra::TRSM_MAXP) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || K <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 1) {
    const int blocks = (batch + psra::TRSM_VEC_WARPS - 1) / psra::TRSM_VEC_WARPS;
    if (forward)
      psra::trsm_vec_kernel<true><<<blocks, psra::TRSM_VEC_WARPS * 32, 0, s>>>(
          L, B, X, batch, P);
    else
      psra::trsm_vec_kernel<false><<<blocks, psra::TRSM_VEC_WARPS * 32, 0, s>>>(
          L, B, X, batch, P);
  } else {
    const dim3 grid(batch, (K + psra::TRSM_COLS - 1) / psra::TRSM_COLS);
    if (forward)
      psra::trsm_cols_kernel<true><<<grid, psra::TRSM_COLS, 0, s>>>(L, B, X, P, K);
    else
      psra::trsm_cols_kernel<false><<<grid, psra::TRSM_COLS, 0, s>>>(L, B, X, P, K);
  }
  return (int)cudaGetLastError();
}
