// Batched Cholesky factorization (K2a) and Cholesky solve (K2b) of many
// small SPD systems (m <= 72), batch-major, float32.
//
// Replaces: the TPU Pallas kernels of
//   powersystemsreliabilityassessment_tpu/ops/batched_chol.py —
//   cholesky_bm (_chol_kernel) and cho_solve_bm (_solve_kernel) —
//   which map 128 systems onto the TPU's vector lanes ("batch-minor").
//
// What bounds it on an H100: the work is small and serial. One m = 56
// factor is ~59 kflop over 56 dependent pivots, a solve 2m dependent
// steps; the bytes (12.5 KB per m = 56 matrix read once, the factor
// written once) are few next to the 3.35 TB/s the card offers. Time
// goes to the latency of each system's chain of dependent steps
// (barriers, shared-memory round trips) and, at 2,048 systems, to the
// schedulers' issue rate. The first port gave each system a 256-thread
// block with two block-wide barriers a pivot and the whole square
// updated every step (0.209 ms for [2048, 56, 56], and a warp a solve
// with a reduction a step, 0.038 ms for [256, 62]; NVIDIA H100 80GB
// HBM3, 700.00 W, scripts/torch_k2_bench.py).
//
// What the design does about it:
// - K2a: a system is a "lane" of one, two or four warps (WPL), several
//   lanes to a block; ops/batched_chol.py::launch_shape picks one warp
//   once the batch fills the card's schedulers and more where it leaves
//   them idle. Only M's lower triangle is staged, by cp.async copies of
//   16, 8 or 4 bytes (the widest m and the pointers allow) walked in row
//   order, so a warp reads consecutive pieces and nothing divides.
//   Shared memory is sized to m; the opt-in is set once per process.
// - Rows are striped over a warp (row i on thread i mod 32, up to three
//   row slots at m = 72), and each row of the triangle starts 16-byte
//   aligned (chol_row_off: rows in groups of 8, each with room for a
//   4-column piece past its diagonal, the 8 rows of a group on 8
//   distinct 16-byte bank groups). The factor is right-looking, blocked
//   by 4 pivots: every thread factors a panel's 4 x 4 diagonal block
//   itself (the same operations as its owner would do, so the same
//   bits), its rows' panel entries in registers, and writes them to its
//   warp's panel buffer (one float4 a row); the columns right of the
//   panel then take their 4 updates in rounds of 4 columns, one 16-byte
//   load, 16 FMAs and one 16-byte store a row, with row j's panel read
//   as one broadcast float4. With WPL > 1 every warp of the lane
//   computes the panel and the warps take the rounds in turn, so the
//   only lane-wide barrier is one a panel (a named barrier; __syncwarp
//   at WPL = 1). A panel's columns go back to shared memory after that
//   barrier, when nothing reads them any more. M being symmetric, a_jk
//   stands in for the reference's a_kj (the upper triangle is never
//   read). Loads are unconditional from addresses clamped inside the
//   row; only stores are predicated. L leaves in coalesced pieces of the
//   square, zeros above the diagonal.
// - K2b: a warp a system, four to a block, row i on thread i mod 32.
//   Only L's lower triangle is staged, packed (row i at i (i + 1) / 2:
//   32 consecutive rows start on 32 distinct banks, so a column read
//   across the warp is conflict-free), by cp.async; 1 / L_kk is taken
//   once, off the chain; forward and back substitution are
//   shuffle-broadcast chains: a step is one shuffle of y_k from its
//   owner and one FMA per row a thread holds.
// - Float32 FFMA throughout, no tensor cores: the panels have condition
//   numbers 1e5-3e6, and K2_L_BOUND / K2_X_BOUND (chip_smoke.py) assume
//   float32 arithmetic.

#include <stdint.h>

#include "common.cuh"

namespace psra {

constexpr int CHOL_KB = 4;           // pivots a panel (columns a round)
constexpr int CHOL_MAX_WARPS = 8;    // warps a block at most
constexpr int SOLVE_LPB = 4;         // systems (warps) a K2b block

__host__ __device__ constexpr int chol_tri(int i) { return i * (i + 1) / 2; }

// K2a's triangle: row i at chol_row_off(i) words. Rows go in groups of 8;
// each row of group k = i / 8 takes 8k + 12 words (its i + 1 entries
// and room for a 4-column round past its diagonal), so every row starts
// 16-byte aligned and a round is one 16-byte load and store a row. The 8
// rows of a group lie 2k + 3 (odd) 16-byte units apart, so a quarter
// warp's 16-byte column reads hit 8 distinct 16-byte bank groups.
__host__ __device__ constexpr int chol_row_off(int i) {
  return 4 * (8 * (i >> 3) * ((i >> 3) + 2) + (i & 7) * (2 * (i >> 3) + 3));
}

// Float32 words of the triangle of an m x m system (whole groups of 8
// rows: a multiple of 32).
__host__ __device__ constexpr int chol_tri_words(int m) {
  return 32 * ((m + 7) >> 3) * (((m + 7) >> 3) + 2);
}

// Float32 words of one K2a lane's shared memory: WPL panel buffers of m
// float4 (one a warp), then the triangle.
__host__ __device__ inline int chol_lane_words(int m, int wpl) {
  return 4 * wpl * m + chol_tri_words(m);
}

// cp.async of V floats (4, 8 or 16 bytes; dst and src V-float aligned).
template <int V>
__device__ __forceinline__ void chol_cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else if constexpr (V == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void chol_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the lower triangle of the row-major m x m matrix `src`
// into `dst`, row i at row_off(i), in pieces of V floats (V | m, src
// V-float aligned): piece c of row i holds columns V c .. V c + V - 1,
// c <= i / V, so a row's last piece may take up to V - 1 columns past
// the diagonal (inside the row, as V | m), which land in dst's row past
// its entries. The pieces go in row order, piece p to thread p mod nt
// of the `nt` copying threads (this one is `tid`), so a warp copies
// consecutive pieces, in a few row segments; rows and pieces are
// walked, not divided.
template <int V, class RowOff>
__device__ __forceinline__ void stage_lower(const float* __restrict__ src,
                                           float* dst, int m, int tid,
                                           int nt, RowOff row_off) {
  int i = 0, c = tid;
  while (c > i / V) c -= i++ / V + 1;
  while (i < m) {
    chol_cp_async<V>(dst + row_off(i) + V * c, src + i * m + V * c);
    c += nt;
    while (c > i / V) c -= i++ / V + 1;
  }
}

// Synchronize the threads of one K2a lane: the warp, or the lane's named
// barrier (ids 1.., 0 being __syncthreads').
template <int WPL>
__device__ __forceinline__ void chol_lane_sync(int bar) {
  if constexpr (WPL == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(32 * WPL) : "memory");
  }
}

// L's rows from K2a's triangle M into the row-major m x m `dst`, zeros
// above the diagonal, in pieces of V floats (V | m, dst V-float
// aligned): the flat pieces of the square, piece p to thread p mod nt
// (coalesced). A piece's load is clamped to the row's diagonal piece, so
// it stays inside the row.
template <int V>
__device__ __forceinline__ void store_lower(float* __restrict__ dst,
                                           const float* M, int m, int tid,
                                           int nt) {
  const int n = m / V;  // pieces a row
  int i = 0, c = tid;
  while (c >= n) { c -= n; ++i; }
  for (int p = tid; p < m * n; p += nt) {
    const int j = V * c;
    const float* src = M + chol_row_off(i) + min(j, V * (i / V));
    auto keep = [&](float v, int q) { return j + q <= i ? v : 0.0f; };
    if constexpr (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      reinterpret_cast<float4*>(dst)[p] = make_float4(
          keep(v.x, 0), keep(v.y, 1), keep(v.z, 2), keep(v.w, 3));
    } else if constexpr (V == 2) {
      const float2 v = *reinterpret_cast<const float2*>(src);
      reinterpret_cast<float2*>(dst)[p] = make_float2(keep(v.x, 0),
                                                      keep(v.y, 1));
    } else {
      dst[p] = keep(*src, 0);
    }
    c += nt;
    while (c >= n) { c -= n; ++i; }
  }
}

// K2a. A lane of WPL warps factors one system; `lpb` lanes a block, each
// with chol_lane_words(m, WPL) words of dynamic shared memory. RS row
// slots a thread: m <= 32 RS. M and L move in pieces of `vec` floats (4,
// 2 or 1: the widest that divides m and both pointers' alignment).
template <int WPL, int RS>
__global__ void __launch_bounds__(CHOL_MAX_WARPS * 32)
cholesky_lanes_kernel(const float* __restrict__ Mg, float* __restrict__ Lg,
                      int batch, int m, int lpb, int vec) {
  constexpr int LT = 32 * WPL;  // threads a lane
  extern __shared__ float4 chol_smem4[];
  const int gl = threadIdx.x / LT, lt = threadIdx.x % LT;
  const int w = lt >> 5, t = lt & 31;
  const int b = blockIdx.x * lpb + gl;
  if (b >= batch) return;  // lane-uniform: the lane's own syncs only
  const int bar = 1 + gl;
  float* base = reinterpret_cast<float*>(chol_smem4)
                + gl * chol_lane_words(m, WPL);
  float4* pbuf = reinterpret_cast<float4*>(base) + w * m;
  float* M = base + 4 * WPL * m;

  {
    const float* src = Mg + (size_t)b * m * m;
    auto ro = [](int i) { return chol_row_off(i); };
    if (vec == 4) stage_lower<4>(src, M, m, lt, LT, ro);
    else if (vec == 2) stage_lower<2>(src, M, m, lt, LT, ro);
    else stage_lower<1>(src, M, m, lt, LT, ro);
  }

  // Per row slot: its row's offset, the last column whose 16-byte piece
  // stays inside the row (reads of a round or panel left of the
  // diagonal are clamped there: unconditional loads, never another
  // row's words), and its row or -1.
  int roff[RS], cap[RS], ilim[RS];
#pragma unroll
  for (int s = 0; s < RS; ++s) {
    const int i = t + 32 * s, ic = min(i, m - 1);
    roff[s] = chol_row_off(ic);
    cap[s] = 8 * (ic >> 3) + 8;
    ilim[s] = i < m ? i : -1;
  }
  chol_cp_async_wait_all();

  // Right-looking, blocked by CHOL_KB pivots, with the plain version's
  // arithmetic (inv = rsqrt(max(a_kk, PIVOT_FLOOR)), column k scaled by
  // inv, a_ij -= l_ik l_jk): each entry takes its updates in pivot
  // order. A last panel past m is padded with zero columns.
  float lq[CHOL_KB][RS];
  for (int K = 0; K < m; K += CHOL_KB) {
    chol_lane_sync<WPL>(bar);  // columns K.. are updated and visible
    // The last panel's columns, which nothing reads any more, back into
    // the triangle (zeros above the diagonal land in a row's spare room).
    if (K > 0 && w == 0) {
#pragma unroll
      for (int s = 0; s < RS; ++s)
        if (ilim[s] >= K - CHOL_KB)
          *reinterpret_cast<float4*>(M + roff[s] + K - CHOL_KB) =
              make_float4(lq[0][s], lq[1][s], lq[2][s], lq[3][s]);
    }
    float dg[CHOL_KB][CHOL_KB], inv[CHOL_KB];
#pragma unroll
    for (int q = 0; q < CHOL_KB; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          M + chol_row_off(min(K + q, m - 1)) + K);
      const float e[CHOL_KB] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r <= q; ++r) dg[q][r] = K + q < m ? e[r] : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < RS; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(
          M + roff[s] + min(K, cap[s]));
      const float e[CHOL_KB] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < CHOL_KB; ++q)
        lq[q][s] = ilim[s] >= K + q ? e[q] : 0.0f;
    }
    // The diagonal block, right-looking (rows K + q2 > K + q).
#pragma unroll
    for (int q = 0; q < CHOL_KB; ++q) {
      inv[q] = rsqrtf(nmax(dg[q][q], PIVOT_FLOOR));
#pragma unroll
      for (int r = q; r < CHOL_KB; ++r) dg[r][q] *= inv[q];
#pragma unroll
      for (int q2 = q + 1; q2 < CHOL_KB; ++q2)
#pragma unroll
        for (int r = q2; r < CHOL_KB; ++r)
          dg[r][q2] = fmaf(-dg[r][q], dg[q2][q], dg[r][q2]);
    }
    // This thread's rows: column q takes the pivots before it, in order,
    // then its scale; a row inside the block takes it from dg.
#pragma unroll
    for (int s = 0; s < RS; ++s) {
      const int dq = t + 32 * s - K;   // its row in the block, if any
#pragma unroll
      for (int q = 0; q < CHOL_KB; ++q) {
        if (dq >= 0 && dq < CHOL_KB) {
#pragma unroll
          for (int r = q; r < CHOL_KB; ++r)  // dg[dq][q], static indices
            if (dq == r) lq[q][s] = dg[r][q];
        } else {
#pragma unroll
          for (int q0 = 0; q0 < q; ++q0)
            lq[q][s] = fmaf(-lq[q0][s], dg[q][q0], lq[q][s]);
          lq[q][s] *= inv[q];
        }
        if (ilim[s] < K + q) lq[q][s] = 0.0f;  // above the diagonal
      }
    }
#pragma unroll
    for (int s = 0; s < RS; ++s)
      if (ilim[s] >= 0)
        pbuf[ilim[s]] = make_float4(lq[0][s], lq[1][s], lq[2][s], lq[3][s]);
    __syncwarp();  // the warp's panel buffer is written

    // The trailing update, in rounds of CHOL_KB columns j0.. (rows j of
    // slot s0); this warp takes every WPL-th round. A round is one
    // 16-byte load, 16 FMAs and one 16-byte store a row (columns past a
    // row's diagonal land in its spare room), every load before any
    // store.
#pragma unroll
    for (int s0 = 0; s0 < RS; ++s0) {
      const int jend = min(m, 32 * (s0 + 1));
      int j0 = max(K + CHOL_KB, 32 * s0);
      j0 += CHOL_KB * ((w - (j0 / CHOL_KB)) & (WPL - 1));
#pragma unroll 1
      for (; j0 < jend; j0 += CHOL_KB * WPL) {
        float4 lj[CHOL_KB], a[RS];
#pragma unroll
        for (int c = 0; c < CHOL_KB; ++c) lj[c] = pbuf[min(j0 + c, m - 1)];
#pragma unroll
        for (int s = s0; s < RS; ++s)
          a[s] = *reinterpret_cast<const float4*>(M + roff[s]
                                                  + min(j0, cap[s]));
#pragma unroll
        for (int s = s0; s < RS; ++s) {
          if (ilim[s] >= j0) {
            // a_ij -= l_iq l_jq, q in pivot order, column j0 + c
            auto upd = [&](float v, const float4& l) {
              v = fmaf(-lq[0][s], l.x, v);
              v = fmaf(-lq[1][s], l.y, v);
              v = fmaf(-lq[2][s], l.z, v);
              return fmaf(-lq[3][s], l.w, v);
            };
            *reinterpret_cast<float4*>(M + roff[s] + j0) = make_float4(
                upd(a[s].x, lj[0]), upd(a[s].y, lj[1]), upd(a[s].z, lj[2]),
                upd(a[s].w, lj[3]));
          }
        }
      }
    }
  }
  chol_lane_sync<WPL>(bar);
  if (w == 0) {
    const int K = (m - 1) / CHOL_KB * CHOL_KB;
#pragma unroll
    for (int s = 0; s < RS; ++s)
      if (ilim[s] >= K)
        *reinterpret_cast<float4*>(M + roff[s] + K) =
            make_float4(lq[0][s], lq[1][s], lq[2][s], lq[3][s]);
  }
  chol_lane_sync<WPL>(bar);

  // L in coalesced rows: the lower triangle, zeros above.
  float* dst = Lg + (size_t)b * m * m;
  if (vec == 4) store_lower<4>(dst, M, m, lt, LT);
  else if (vec == 2) store_lower<2>(dst, M, m, lt, LT);
  else store_lower<1>(dst, M, m, lt, LT);
}

// K2b. A warp solves L L' x = r for one system, SOLVE_LPB systems a
// block, each with chol_tri(m) words of dynamic shared memory. RS row
// slots a thread: m <= 32 RS.
template <int RS>
__global__ void __launch_bounds__(SOLVE_LPB * 32)
cho_solve_kernel(const float* __restrict__ Lg, const float* __restrict__ r,
                 float* __restrict__ x, int batch, int m) {
  extern __shared__ float4 solve_smem4[];
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * SOLVE_LPB + w;
  if (b >= batch) return;  // warp-uniform: only __syncwarp follows
  float* Ls = reinterpret_cast<float*>(solve_smem4) + w * chol_tri(m);
  stage_lower<1>(Lg + (size_t)b * m * m, Ls, m, t, 32,
                 [](int i) { return chol_tri(i); });

  float z[RS], rec[RS];
  int toff[RS], rowc[RS];
#pragma unroll
  for (int s = 0; s < RS; ++s) {
    const int i = t + 32 * s;
    rowc[s] = min(i, m - 1);   // loads stay inside the triangle
    toff[s] = chol_tri(rowc[s]);
    z[s] = i < m ? r[(size_t)b * m + i] : 0.0f;
  }
  chol_cp_async_wait_all();
  __syncwarp();
#pragma unroll
  for (int s = 0; s < RS; ++s) rec[s] = 1.0f / Ls[toff[s] + rowc[s]];

  // L y = r: y_k = z_k / L_kk from its owner, then z_i -= L_ik y_k.
  int k = 0;
#pragma unroll
  for (int s0 = 0; s0 < RS; ++s0) {
    const int kend = min(m, 32 * (s0 + 1));
#pragma unroll 4
    for (; k < kend; ++k) {
      float l[RS];
#pragma unroll
      for (int s = s0; s < RS; ++s) l[s] = Ls[toff[s] + min(k, rowc[s])];
      const float yk = __shfl_sync(0xffffffffu, z[s0] * rec[s0], k - 32 * s0);
#pragma unroll
      for (int s = s0; s < RS; ++s) {
        const int i = t + 32 * s;
        const float upd = fmaf(-l[s], yk, z[s]);
        z[s] = i == k ? yk : (i > k ? upd : z[s]);
      }
    }
  }
  // L' x = y: x_k = y_k / L_kk from its owner, then y_i -= L_ki x_k.
  k = m - 1;
#pragma unroll
  for (int s0 = RS - 1; s0 >= 0; --s0) {
#pragma unroll 4
    for (; k >= 32 * s0; --k) {
      const float* Lk = Ls + chol_tri(k);
      float l[RS];
#pragma unroll
      for (int s = 0; s <= s0; ++s) l[s] = Lk[min(t + 32 * s, k)];
      const float xk = __shfl_sync(0xffffffffu, z[s0] * rec[s0], k - 32 * s0);
#pragma unroll
      for (int s = 0; s <= s0; ++s) {
        const int i = t + 32 * s;
        const float upd = fmaf(-l[s], xk, z[s]);
        z[s] = i == k ? xk : (i < k ? upd : z[s]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < RS; ++s)
    if (t + 32 * s < m) x[(size_t)b * m + t + 32 * s] = z[s];
}

using CholKernel = void (*)(const float*, float*, int, int, int, int);
using SolveKernel = void (*)(const float*, const float*, float*, int, int);

// The K2a instance for (warps a lane, m), its index, or -1.
inline int chol_instance(int wpl, int m, CholKernel* kern) {
  const int rs = (m + 31) / 32;
  if (m < 1 || m > MAXM) return -1;
  static const CholKernel table[3][3] = {
      {cholesky_lanes_kernel<1, 1>, cholesky_lanes_kernel<1, 2>,
       cholesky_lanes_kernel<1, 3>},
      {cholesky_lanes_kernel<2, 1>, cholesky_lanes_kernel<2, 2>,
       cholesky_lanes_kernel<2, 3>},
      {cholesky_lanes_kernel<4, 1>, cholesky_lanes_kernel<4, 2>,
       cholesky_lanes_kernel<4, 3>}};
  const int wi = wpl == 1 ? 0 : wpl == 2 ? 1 : wpl == 4 ? 2 : -1;
  if (wi < 0) return -1;
  *kern = table[wi][rs - 1];
  return 3 * wi + rs - 1;
}

// Allow a K2a instance the device's whole opt-in shared memory, once per
// process and device.
inline cudaError_t chol_prepare(int inst, CholKernel kern) {
  static uint64_t ready[9] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (ready[inst] >> dev & 1)) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess && dev < 64) ready[inst] |= 1ull << dev;
  return err;
}

}  // namespace psra

// C interface (bound with ctypes). Pointers are device pointers of
// contiguous float32 tensors; the wrapper checks shapes. Each function
// launches on `stream`, allocates nothing and returns cudaGetLastError().
//
// K2a: ceil(batch / lanes_per_block) blocks of lanes_per_block x 32 x
// warps_per_lane threads with smem_bytes of dynamic shared memory, which
// must equal lanes_per_block x chol_lane_words(m, warps_per_lane) x 4
// (ops/batched_chol.py::launch_shape computes all three);
// cudaErrorInvalidValue for a size off that layout or a shape no
// instance takes.
extern "C" int psra_cholesky(const float* M, float* L, int batch, int m,
                             int warps_per_lane, int lanes_per_block,
                             int smem_bytes, void* stream) {
  psra::CholKernel kern = nullptr;
  const int inst = psra::chol_instance(warps_per_lane, m, &kern);
  if (inst < 0 || lanes_per_block < 1
      || lanes_per_block * warps_per_lane > psra::CHOL_MAX_WARPS
      || smem_bytes != (int)sizeof(float) * lanes_per_block
                           * psra::chol_lane_words(m, warps_per_lane))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = psra::chol_prepare(inst, kern);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    const int grid = (batch + lanes_per_block - 1) / lanes_per_block;
    const uintptr_t align = (uintptr_t)M | (uintptr_t)L;
    const int vec = m % 4 == 0 && align % 16 == 0 ? 4
                    : m % 2 == 0 && align % 8 == 0 ? 2 : 1;
    kern<<<grid, lanes_per_block * 32 * warps_per_lane, smem_bytes,
           (cudaStream_t)stream>>>(M, L, batch, m, lanes_per_block, vec);
  }
  return (int)cudaGetLastError();
}

// K2b: ceil(batch / SOLVE_LPB) blocks of SOLVE_LPB warps, with
// SOLVE_LPB x chol_tri(m) x 4 bytes of dynamic shared memory (<= 42 KB).
extern "C" int psra_cho_solve(const float* L, const float* r, float* x,
                              int batch, int m, void* stream) {
  static const psra::SolveKernel table[3] = {psra::cho_solve_kernel<1>,
                                             psra::cho_solve_kernel<2>,
                                             psra::cho_solve_kernel<3>};
  if (m < 1 || m > psra::MAXM) return (int)cudaErrorInvalidValue;
  const psra::SolveKernel kern = table[(m + 31) / 32 - 1];
  const int smem = (int)sizeof(float) * psra::SOLVE_LPB * psra::chol_tri(m);
  const int grid = (batch + psra::SOLVE_LPB - 1) / psra::SOLVE_LPB;
  if (batch > 0)
    kern<<<grid, psra::SOLVE_LPB * 32, smem, (cudaStream_t)stream>>>(
        L, r, x, batch, m);
  return (int)cudaGetLastError();
}
