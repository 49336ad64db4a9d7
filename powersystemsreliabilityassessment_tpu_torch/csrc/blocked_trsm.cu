// Batched lower-triangular solves on one diagonal panel (K3): per lane b,
// X_b = L_b^-1 B_b (forward) or X_b = L_b^-T B_b (backward), L_b [P, P]
// lower triangular with P <= 64, B_b [P, K]; batch-major, float32. Only
// the lower triangle of L is read.
//
// Replaces: the TPU Pallas kernels of
//   powersystemsreliabilityassessment_tpu/ops/blocked_chol.py —
//   trsm_fwd (_trsm_fwd_kernel) and trsm_bwd (_trsm_bwd_kernel), launched
//   by _call_trsm — which map 128 lanes onto the TPU's vector lanes
//   ("batch-minor") and walk the P rows in a fori_loop.
//
// What bounds it on an H100 (2,048 lanes, RTS-96's max_lp; bytes = L's
// triangle + B + X, each once, over 3.35 TB/s):
//   P 56, K 1  (every solve, probe and refinement)  14.0 MB, 4.2 us
//   P 23, K 1  (the last, 23-wide panel)             2.6 MB, 0.8 us
//   P 56, K 56 (off-diagonal blocks of the factor)  64.4 MB, 19.2 us
//   P 56, K 23 (the 23-row off-diagonal blocks)     34.2 MB, 10.2 us
// Every shape is bytes-bound at the roofline (K 56 needs 5.5 us of
// float32 FMAs), but K = 1 has almost no work per byte: a lane is a chain
// of P dependent steps, so every lane's triangle has to be in flight at
// once and each step has to be short. A kernel's start and drain
// (~3 us) exceed the P 23 bound by themselves.
//
// What the design does about it:
// - Only the lower triangle is staged, with cp.async (no registers, no
//   wait until the data is needed), into shared memory sized from P at
//   launch, not from the 64-wide maximum.
// - K = 1 (trsm_vec_kernel): a warp per lane, in a grid-stride loop over
//   lanes with two stages per warp, so the next lane's copy is in flight
//   while this lane solves; the grid is what fits on the card at once
//   (occupancy API, the largest shared-memory carveout), which at P <= 56
//   holds all 2,048 lanes. The triangle is packed (row i at i (i + 1) / 2,
//   4-byte copies): the triangular numbers of 32 consecutive rows are
//   distinct mod 32, so the column reads below hit 32 banks, which no
//   16-byte aligned row layout allows. Rows are striped over the warp in
//   registers (rows t and t + 32 on thread t); the substitution sweeps
//   columns: at step j the owner's y_j becomes x_j = y_j / l_jj (the
//   divide kept, as in the plain version), one __shfl_sync broadcasts it,
//   and every other unsolved row takes one FMA with L's column j
//   (forward) or row j (backward): P rounds of shuffle, divide and FMA in
//   place of P five-step reductions.
// - K > 1 (trsm_cols_kernel): a thread per right-hand-side column with x
//   in registers, several lanes per block (floor(128 / K) lanes at
//   K <= 128, so K = 23 keeps 115 of 128 threads busy), B read and X
//   written coalesced across columns, B's loads issued before the
//   triangles' copy is waited for. Triangles in rows padded to 4 floats,
//   copied in 16-byte pieces where L's rows are 16-byte aligned
//   (P % 4 == 0, so P = 56), else 4 bytes; read as float4 broadcasts;
//   forward a row dot product with four partial sums, backward a row
//   sweep. Templated on P = 56 (fully unrolled), with a generic P <= 64
//   instance of the same kernel. One stage a block: a persistent
//   two-stage variant with B staged in shared memory fit 8 warps a SM
//   instead of 20 and measured slower at K 56.
// - No tensor cores: the port runs float32 with TF32 off, K3_BOUND
//   (1e-3 per lane, chip_smoke.py) and the probe's PROBE_BAD_REL
//   assume float32 substitution, wgmma takes no float32 operands, and
//   splitting into 3 x TF32 would triple the work of a bytes-bound kernel.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace psra {

constexpr int TRSM_MAXP = 64;          // widest panel (blocked_chol.PANEL = 56)
constexpr int TRSM_VEC_WARPS = 4;      // warps (one lane each) per block, K = 1
constexpr int TRSM_COLS_THREADS = 128; // threads per block, K > 1
constexpr int TRSM_COLS_SMEM = 48 * 1024;  // K > 1 triangles per block, bytes

// Offset of row i in a packed triangle (row i holds i + 1 floats).
__host__ __device__ constexpr int tri_off(int i) { return i * (i + 1) / 2; }

// Offset of row i when every row is padded to a multiple of 4 floats
// (row r takes 4 ceil((r + 1) / 4)): 16-byte aligned rows.
__host__ __device__ constexpr int pad_off(int i) {
  return 4 * ((i >> 2) + 1) * (2 * (i >> 2) + (i & 3));
}

template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// num / d rounded as IEEE division, as the plain version divides. The
// compiled division takes a slow subroutine for a zero numerator, and the
// factor's off-diagonal blocks (the K > 1 right-hand sides) are ~97%
// zeros on RTS-96, so a zero over a finite nonzero d is answered
// directly: +-0 with the quotient's sign. The K = 1 chain keeps the plain
// division: its right-hand sides are dense on the path, where the test
// cost ~1 us a call.
__device__ __forceinline__ float div_rn(float num, float d) {
  if (num == 0.0f && fabsf(d) < INFINITY && d != 0.0f)
    return d > 0.0f ? num : -num;
  return num / d;
}

// Start copying the lower triangle of lane b's row-major P x P factor Lb
// into a packed triangle (row i at tri_off(i)), by one warp: thread t
// copies entries t and t + 32 of each row, 4 bytes each. Warp-uniform
// rows: unrolled where P is a constant, the offsets are immediates.
__device__ __forceinline__ void stage_tri_packed(const float* __restrict__ Lb,
                                                 float* dst, int P, int t) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (t <= i) cp_async<1>(dst + tri_off(i) + t, Lb + i * P + t);
    if (t + 32 <= i) cp_async<1>(dst + tri_off(i) + t + 32, Lb + i * P + t + 32);
  }
}

// The same into rows padded to 4 floats (row i at pad_off(i)), by one
// warp. VEC: 16-byte pieces, two rows a warp instruction (16 threads a
// row; a row of P <= 64 has <= 16 pieces, the last one also copying up
// to three entries of the upper triangle, which nobody reads); needs
// P % 4 == 0 and a 16-byte aligned Lb. Else 4-byte pieces, a row at a
// time.
template <bool VEC>
__device__ __forceinline__ void stage_tri_padded(const float* __restrict__ Lb,
                                                 float* dst, int P, int t) {
  if (VEC) {
    const int h = t >> 4, q = t & 15;
#pragma unroll
    for (int i0 = 0; i0 < P; i0 += 2) {
      const int i = i0 + h;
      if (i < P && q <= (i >> 2))
        cp_async<4>(dst + pad_off(i) + 4 * q, Lb + i * P + 4 * q);
    }
  } else {
    for (int i = 0; i < P; ++i)
      for (int j = t; j <= i; j += 32)
        cp_async<1>(dst + pad_off(i) + j, Lb + i * P + j);
  }
}

// K = 1. PT > 0: P == PT, unrolled; PT == 0: any P <= 64.
template <bool FWD, int PT>
__global__ void __launch_bounds__(TRSM_VEC_WARPS * 32)
trsm_vec_kernel(const float* __restrict__ L, const float* __restrict__ r,
                float* __restrict__ x, int batch, int P_) {
  const int P = PT ? PT : P_;
  const int T = tri_off(P), S = T + P;  // floats of one stage: L, then r
  extern __shared__ float4 trsm_smem_v[];
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  float* stages = reinterpret_cast<float*>(trsm_smem_v) + w * 2 * S;
  const int nw = gridDim.x * TRSM_VEC_WARPS;
  int b = blockIdx.x * TRSM_VEC_WARPS + w;
  if (b >= batch) return;  // warp-uniform: only __syncwarp follows
  auto issue = [&](int lane, float* st) {
    stage_tri_packed(L + (size_t)lane * P * P, st, P, t);
    for (int i = t; i < P; i += 32) cp_async<1>(st + T + i, r + (size_t)lane * P + i);
  };
  issue(b, stages);
  cp_async_commit();
  const int o0 = tri_off(t), o1 = tri_off(t + 32);  // rows t and t + 32
  for (int it = 0; b < batch; b += nw, ++it) {
    const float* st = stages + (it & 1) * S;
    if (b + nw < batch) issue(b + nw, stages + ((it + 1) & 1) * S);
    cp_async_commit();
    cp_async_wait<1>();  // this lane's copies (the next lane's may fly)
    __syncwarp();        // ... and the other threads' copies
    float y0 = t < P ? st[T + t] : 0.0f;
    float y1 = t + 32 < P ? st[T + t + 32] : 0.0f;
    if (FWD) {
      // x_j = y_j / l_jj; y_i -= l_ij x_j for i > j
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float xj = __shfl_sync(0xffffffffu, j < 32 ? y0 : y1, j & 31)
                         / st[tri_off(j) + j];
        if (t == (j & 31)) {
          if (j < 32) y0 = xj; else y1 = xj;
        }
        if (t > j && t < P) y0 = fmaf(-st[o0 + j], xj, y0);
        if (t + 32 > j && t + 32 < P) y1 = fmaf(-st[o1 + j], xj, y1);
      }
    } else {
      // x_j = y_j / l_jj; y_i -= l_ji x_j for i < j
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        const float* row = st + tri_off(j);
        const float xj = __shfl_sync(0xffffffffu, j < 32 ? y0 : y1, j & 31)
                         / row[j];
        if (t == (j & 31)) {
          if (j < 32) y0 = xj; else y1 = xj;
        }
        if (t < j) y0 = fmaf(-row[t], xj, y0);
        if (t + 32 < j) y1 = fmaf(-row[t + 32], xj, y1);
      }
    }
    if (t < P) x[(size_t)b * P + t] = y0;
    if (t + 32 < P) x[(size_t)b * P + t + 32] = y1;
    __syncwarp();  // every read of this stage is done before it is refilled
  }
  cp_async_wait<0>();
}

// K > 1 substitution of one column held in registers, from one lane's
// triangle in padded rows (row i at pad_off(i)), read as float4
// broadcasts: forward a row dot product with four partial sums, backward
// a row sweep. PT = 56: P == 56, unrolled; PT == TRSM_MAXP: any P <= 64.
template <bool FWD, int PT>
__device__ __forceinline__ void solve_column(float (&xr)[PT],
                                             const float* __restrict__ ls,
                                             int P) {
  constexpr bool EXACT = PT != TRSM_MAXP;
  if (FWD) {
    // x_i = (b_i - sum_{k<i} l_ik x_k) / l_ii, four partial sums
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      if (EXACT || i < P) {
        const float* row = ls + pad_off(i);
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
        for (int k = 0; k < i; k += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + k);
          s0 = fmaf(v.x, xr[k], s0);
          if (k + 1 < i) s1 = fmaf(v.y, xr[k + 1], s1);
          if (k + 2 < i) s2 = fmaf(v.z, xr[k + 2], s2);
          if (k + 3 < i) s3 = fmaf(v.w, xr[k + 3], s3);
        }
        xr[i] = div_rn(xr[i] - ((s0 + s1) + (s2 + s3)), row[i]);
      }
    }
  } else {
    // x_j = y_j / l_jj; y_k -= l_jk x_j for k < j
#pragma unroll
    for (int j = PT - 1; j >= 0; --j) {
      if (EXACT || j < P) {
        const float* row = ls + pad_off(j);
        xr[j] = div_rn(xr[j], row[j]);
#pragma unroll
        for (int k = 0; k < j; k += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + k);
          xr[k] = fmaf(-v.x, xr[j], xr[k]);
          if (k + 1 < j) xr[k + 1] = fmaf(-v.y, xr[j], xr[k + 1]);
          if (k + 2 < j) xr[k + 2] = fmaf(-v.z, xr[j], xr[k + 2]);
          if (k + 3 < j) xr[k + 3] = fmaf(-v.w, xr[j], xr[k + 3]);
        }
      }
    }
  }
}

// K > 1: a thread per column of B, `lpb` lanes of `kc` columns per block
// (blockIdx.y picks a chunk of kc columns when K > kc). B's loads go to
// registers before the triangles' copies are waited for.
template <bool FWD, int PT>
__global__ void __launch_bounds__(TRSM_COLS_THREADS)
trsm_cols_kernel(const float* __restrict__ L, const float* __restrict__ Bm,
                 float* __restrict__ X, int batch, int P_, int K, int kc,
                 int lpb, int vec) {
  constexpr bool EXACT = PT != TRSM_MAXP;
  const int P = EXACT ? PT : P_;
  extern __shared__ float4 trsm_smem_c[];
  float* sm = reinterpret_cast<float*>(trsm_smem_c);
  const int tsize = pad_off(P);
  const size_t lane0 = (size_t)blockIdx.x * lpb;
  const int nl = min(lpb, (int)(batch - lane0));
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  for (int l = w; l < nl; l += blockDim.x >> 5) {
    const float* Lb = L + (lane0 + l) * P * P;
    if (vec) stage_tri_padded<true>(Lb, sm + l * tsize, P, t);
    else stage_tri_padded<false>(Lb, sm + l * tsize, P, t);
  }
  cp_async_commit();
  const int ll = threadIdx.x / kc;
  const int col = blockIdx.y * kc + threadIdx.x - ll * kc;
  const bool active = ll < nl && col < K;
  const size_t off = (lane0 + ll) * P * K + col;
  float xr[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i)
    xr[i] = (active && (EXACT || i < P)) ? Bm[off + (size_t)i * K] : 0.0f;
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;
  solve_column<FWD, PT>(xr, sm + ll * tsize, P);
#pragma unroll
  for (int i = 0; i < PT; ++i)
    if (EXACT || i < P) X[off + (size_t)i * K] = xr[i];
}

// K = 1 launch: the grid is what fits on the device at once (capped by
// the lanes), from the occupancy API after allowing the kernel its
// dynamic shared memory (above 48 KB it must ask) and preferring the
// largest shared-memory carveout of the SM's 256 KB (the rest is L1,
// which the kernel does not reuse). Asked again when the device or P
// changes.
template <bool FWD, int PT>
void launch_vec(const float* L, const float* r, float* x, int batch, int P,
                cudaStream_t s) {
  static int cached_dev = -1, cached_p = -1, fit = 1;
  const int threads = TRSM_VEC_WARPS * 32;
  const size_t smem = sizeof(float) * TRSM_VEC_WARPS * 2 * (tri_off(P) + P);
  auto kern = trsm_vec_kernel<FWD, PT>;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev || P != cached_p) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    fit = std::max(1, per_sm * sms);
    cached_dev = dev;
    cached_p = P;
  }
  const int need = (batch + TRSM_VEC_WARPS - 1) / TRSM_VEC_WARPS;
  kern<<<std::min(need, fit), threads, smem, s>>>(L, r, x, batch, P);
}

template <bool FWD>
void launch_vec_p(const float* L, const float* r, float* x, int batch, int P,
                  cudaStream_t s) {
  if (P == 56) launch_vec<FWD, 56>(L, r, x, batch, P, s);
  else if (P == 23) launch_vec<FWD, 23>(L, r, x, batch, P, s);
  else launch_vec<FWD, 0>(L, r, x, batch, P, s);
}

template <bool FWD>
void launch_cols(const float* L, const float* B, float* X, int batch, int P,
                 int K, cudaStream_t s) {
  const int kc = std::min(K, TRSM_COLS_THREADS);
  const int tri_bytes = (int)sizeof(float) * pad_off(P);
  const int lpb =
      std::max(1, std::min(TRSM_COLS_THREADS / kc, TRSM_COLS_SMEM / tri_bytes));
  const int threads = (lpb * kc + 31) / 32 * 32;
  const dim3 grid((batch + lpb - 1) / lpb, (K + kc - 1) / kc);
  const size_t smem = (size_t)lpb * tri_bytes;
  const int vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0;
  if (P == 56)
    trsm_cols_kernel<FWD, 56><<<grid, threads, smem, s>>>(L, B, X, batch, P, K,
                                                          kc, lpb, vec);
  else
    trsm_cols_kernel<FWD, TRSM_MAXP><<<grid, threads, smem, s>>>(
        L, B, X, batch, P, K, kc, lpb, vec);
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
    if (forward) psra::launch_vec_p<true>(L, B, X, batch, P, s);
    else psra::launch_vec_p<false>(L, B, X, batch, P, s);
  } else {
    if (forward) psra::launch_cols<true>(L, B, X, batch, P, K, s);
    else psra::launch_cols<false>(L, B, X, batch, P, K, s);
  }
  return (int)cudaGetLastError();
}
