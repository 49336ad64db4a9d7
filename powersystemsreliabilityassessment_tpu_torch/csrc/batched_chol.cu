// Batched Cholesky factorization and Cholesky solve of many small SPD
// systems (m <= 72), batch-major, float32.
//
// Replaces: the TPU Pallas kernels of
//   powersystemsreliabilityassessment_tpu/ops/batched_chol.py —
//   cholesky_bm (_chol_kernel) and cho_solve_bm (_solve_kernel) —
//   which map 128 systems onto the TPU's vector lanes ("batch-minor").
//
// What bounds it on an H100: the work is tiny and serial. One m = 62
// factorization is ~80k flops over 62 dependent steps, and a solve is
// 124 dependent dot products; the bytes (15 KB per matrix read once)
// are negligible next to the 3.35 TB/s the card offers. Time goes to
// step latency (barriers, shared-memory round trips), not to flops or
// device-memory bandwidth.
//
// What the design does about it: one thread block per system keeps the
// whole matrix in shared memory (m <= 72: at most 20.7 KB) for every
// step of the factorization, so device memory is touched once on the
// way in and once on the way out; the trailing update of each step is
// spread over the block's 256 threads. The solve gives each system one
// warp (two systems per block) with its factor staged in shared memory,
// so each substitution step is one warp-shuffle reduction with no
// block-wide barrier. Batch-major layout is kept: the TPU's
// batch-minor transposes are not needed here.

#include "common.cuh"

namespace psra {

constexpr int CHOL_THREADS = 256;
constexpr int SOLVE_WARPS = 2;

__global__ void __launch_bounds__(CHOL_THREADS)
cholesky_kernel(const float* __restrict__ M, float* __restrict__ L, int m) {
  __shared__ float a[MAXM * MAXM];
  const size_t off = (size_t)blockIdx.x * m * m;
  for (int t = threadIdx.x; t < m * m; t += blockDim.x) a[t] = M[off + t];
  chol_inplace(a, m, m);
  for (int t = threadIdx.x; t < m * m; t += blockDim.x) {
    const int i = t / m, j = t % m;
    L[off + t] = j <= i ? a[t] : 0.0f;
  }
}

__global__ void __launch_bounds__(SOLVE_WARPS * 32)
cho_solve_kernel(const float* __restrict__ L, const float* __restrict__ r,
                 float* __restrict__ x, int batch, int m) {
  __shared__ float ls[SOLVE_WARPS][MAXM * MAXM];
  __shared__ float ys[SOLVE_WARPS][MAXM];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * SOLVE_WARPS + w;
  if (b >= batch) return;  // warp-uniform: only __syncwarp follows
  float* lw = ls[w];
  float* y = ys[w];
  const size_t off = (size_t)b * m * m;
  for (int t = lane; t < m * m; t += 32) lw[t] = L[off + t];
  for (int t = lane; t < m; t += 32) y[t] = r[(size_t)b * m + t];
  __syncwarp();
  // Forward: L y = r, y_i = (r_i - sum_{j<i} L_ij y_j) / L_ii.
  for (int i = 0; i < m; ++i) {
    float s = 0.0f;
    for (int j = lane; j < i; j += 32) s += lw[i * m + j] * y[j];
    s = warp_reduce<kSum>(s);
    if (lane == 0) y[i] = (y[i] - s) / lw[i * m + i];
    __syncwarp();
  }
  // Backward: L' x = y, x_i = (y_i - sum_{j>i} L_ji x_j) / L_ii.
  for (int i = m - 1; i >= 0; --i) {
    float s = 0.0f;
    for (int j = i + 1 + lane; j < m; j += 32) s += lw[j * m + i] * y[j];
    s = warp_reduce<kSum>(s);
    if (lane == 0) y[i] = (y[i] - s) / lw[i * m + i];
    __syncwarp();
  }
  for (int t = lane; t < m; t += 32) x[(size_t)b * m + t] = y[t];
}

}  // namespace psra

// C interface (bound with ctypes). Pointers are device pointers of
// contiguous float32 tensors; the wrapper checks shapes. Each function
// launches on `stream`, allocates nothing and returns cudaGetLastError().
extern "C" int psra_cholesky(const float* M, float* L, int batch, int m,
                             void* stream) {
  if (batch > 0)
    psra::cholesky_kernel<<<batch, psra::CHOL_THREADS, 0,
                            (cudaStream_t)stream>>>(M, L, m);
  return (int)cudaGetLastError();
}

extern "C" int psra_cho_solve(const float* L, const float* r, float* x,
                              int batch, int m, void* stream) {
  const int blocks = (batch + psra::SOLVE_WARPS - 1) / psra::SOLVE_WARPS;
  if (batch > 0)
    psra::cho_solve_kernel<<<blocks, psra::SOLVE_WARPS * 32, 0,
                             (cudaStream_t)stream>>>(L, r, x, batch, m);
  return (int)cudaGetLastError();
}
