// Fused sampler + first-pass certificate (K4): per state lane, draw the
// outage indicators (K6's rule and counters) or take explicit states,
// compute the exact copper deficit, the hint-shaped shed candidate at
// that bound, the locally balanced dispatch, and the LODF-corrected
// post-outage flows behind a rigorous rounding guard band; write the
// states, the first-pass mask, the deficit and the shed candidate.
//
// Replaces: the TPU Pallas kernel of
//   powersystemsreliabilityassessment_tpu/ops/fused_sampler_cert.py —
//   _call_kernel (body _make_kernel), which grades its MXU dots between
//   bf16 and emulated bf16x3 precision and inflates its band for that
//   (EPS_HIGH). Here every product is a float32 FMA chain; the band is
//   derived again for that arithmetic (ops/fused_sampler_cert.py).
//
// What bounds it on an H100: operations. Per RTS-24 lane ~16 kFLOP of
// float32 work (the flows and their error bound are two [nb] x [nb, nl]
// products) and ~1,900 32-bit integer operations in its 18 Philox
// calls: ~0.025 ms at B = 262144 and 67 TFLOP/s, against ~150 bytes a
// lane (0.012 ms).
//
// What the design does about it: one thread per state lane, so each
// warp instruction serves 32 lanes and no lane waits on a warp
// reduction or a warp barrier.
// - States: the thread runs its row's Philox calls (philox.cuh, so the
//   states are K6's bit for bit) into a 128-bit outage mask in
//   registers; the row's bytes go out through shared memory as
//   coalesced 16-byte stores (explicit states come in the same way).
// - Sums: the deficit, the candidate and the dispatch are sequential
//   sums over the network's per-bus lists (uniform loop bounds,
//   broadcast reads), the units taken in list order with their
//   capacities and outage bits in that order. The candidate and the
//   dispatch are functions of a few per-lane scalars and are recomputed
//   where they are needed, so a lane keeps one vector, its bus sums, in
//   shared memory laid out [bus][lane] (no bank conflicts).
// - Flows: streamed over chunks of QUICK_CHUNK branches whose flows and
//   bounds live in registers, each PTDF row read as broadcast 16-byte
//   loads; each branch takes the rank-1 LODF update and the banded test
//   and is dropped. The outaged branch's own flow is computed first, by
//   the same FMA chain.
// - The shed candidate goes out through shared memory too. The
//   network's small vectors and PTDF (rows padded to the chunk) sit in
//   shared memory, LODF too where it fits.
// - A small batch leaves most of the card idle at one thread a lane, so
//   a lane may be split over 2-8 neighbouring threads of a warp: they
//   share its Philox calls, its buses and its branch chunks, and repeat
//   its few sequential sums, so every split gives the same bits. The
//   wrapper chooses the block and the split
//   (ops/fused_sampler_cert.py::launch_shape).

#include <stdint.h>

#include "cert_common.cuh"
#include "philox.cuh"

namespace psra {

constexpr int QUICK_MAX_LANES = 128;     // state lanes a block
constexpr int QUICK_MAX_THREADS = 256;   // lanes x threads a lane
constexpr int QUICK_CHUNK = 8;           // branches a flow pass carries
// Bits 8-9 of `stage`: log2 of the threads a lane (1, 2, 4 or 8).
constexpr int QUICK_SPLIT_SHIFT = 8;

// The shared-memory plan, mirrored by ops/fused_sampler_cert.py.
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Words of the broadcast vectors: thresholds [nc], pmax [ng] in unit
// order and [ng] in list order, each unit's position in the unit lists
// [ng], load and hint [nd], bus load [nb], rate + 1e-4 [nl], and the
// list pointers and load indices (bg_ptr [nb + 1], bl_ptr [nb + 1],
// bl_idx [nd]).
__host__ __device__ __forceinline__ int quick_small_words(int ng, int nd,
                                                          int nl, int nb) {
  return round4((ng + nl) + 3 * ng + 3 * nd + 3 * nb + nl + 2);
}

__host__ __device__ __forceinline__ int quick_ptdf_stride(int nl) {
  return (nl + QUICK_CHUNK - 1) / QUICK_CHUNK * QUICK_CHUNK;
}

// Words before the lanes' region: the vectors, PTDF (always: <= 64 KB
// for dimensions <= 128), then LODF where `stage` flags it.
__host__ __device__ __forceinline__ int quick_staged_words(int ng, int nd,
                                                           int nl, int nb,
                                                           int stage) {
  return quick_small_words(ng, nd, nl, nb) + nb * quick_ptdf_stride(nl) +
         ((stage & STAGE_LODF) ? round4(nl * nl) : 0);
}

// Bytes a lane takes: its bus sums [nb] floats, and the exchange region
// its state bytes [nc] and then its shed floats [nd] pass through.
__host__ __device__ __forceinline__ int quick_lane_bytes(int ng, int nd,
                                                         int nl, int nb) {
  const int nc = ng + nl;
  return 4 * nb + round4(nc > 4 * nd ? nc : 4 * nd);
}

// The network as the lanes read it: shared copies, and LODF in device
// memory where it is not staged.
struct QuickNet {
  int ng, nd, nl, nb;
  const int* thresh;                  // [nc]; null in explicit mode
  const float* pmax;                  // [ng], unit order
  const float* pmax_at;               // [ng], unit-list order
  const int* list_pos;                // [ng]: unit u is at list_pos[u]
  const float *load, *hint, *load_bus, *rate_ok;
  const int *bg_ptr, *bl_ptr, *bl_idx;
  const float* ptdf;                  // [nb][ptdf_stride]: PTDF[l, b]
  int ptdf_stride;                    // nl rounded up to QUICK_CHUNK
  const float* lodf;                  // [nl][nl]
  float load_tot, pmax_tot;
};

// Start an asynchronous 4-byte copy from device to shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Start copying n words from src (if not null) to the shared words at
// cur, by the whole block; advance cur.
template <typename T>
__device__ __forceinline__ const T* stage_into(float*& cur, const T* src,
                                               int n) {
  T* dst = reinterpret_cast<T*>(cur);
  if (src)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      cp_async4(dst + i, src + i);
  cur += n;
  return dst;
}

// Copy the vectors, PTDF and (if flagged) LODF into shared memory by
// the whole block, every copy in flight at once, and lay the units'
// capacities out in list order. Returns the first word of the lanes'
// region.
__device__ __forceinline__ float* quick_stage(QuickNet& q, const float* fbuf,
                                              const int* ibuf,
                                              const int* thresh, int stage,
                                              float* smem) {
  const int ng = q.ng, nd = q.nd, nl = q.nl, nb = q.nb;
  const Net net = net_unpack(fbuf, ibuf, ng, nd, nl, nb);
  // Extras after the network floats: load [nd], hint [nd], bus load
  // [nb], then (load total, capacity total).
  const float* x = fbuf + net_floats(ng, nl, nb);
  q.load_tot = x[2 * nd + nb];
  q.pmax_tot = x[2 * nd + nb + 1];
  float* cur = smem;
  q.thresh = stage_into(cur, thresh, ng + nl);
  q.pmax = stage_into(cur, net.pmax, ng);
  float* pmax_at = cur;
  int* list_pos = reinterpret_cast<int*>(cur + ng);
  q.pmax_at = pmax_at;
  q.list_pos = list_pos;
  cur += 2 * ng;
  q.load = stage_into(cur, x, nd);
  q.hint = stage_into(cur, x + nd, nd);
  q.load_bus = stage_into(cur, x + 2 * nd, nb);
  q.rate_ok = stage_into(cur, net.rate_ok, nl);
  q.bg_ptr = stage_into(cur, net.bg_ptr, nb + 1);
  q.bl_ptr = stage_into(cur, net.bl_ptr, nb + 1);
  q.bl_idx = stage_into(cur, net.bl_idx, nd);
  cur = smem + quick_small_words(ng, nd, nl, nb);
  const int s = quick_ptdf_stride(nl);
  for (int b = 0; b < nb; ++b)
    for (int l = threadIdx.x; l < s; l += blockDim.x) {
      if (l < nl) cp_async4(cur + b * s + l, net.ptdfT + b * nl + l);
      else cur[b * s + l] = 0.0f;   // padding: the chunk's spare columns
    }
  q.ptdf = cur;
  q.ptdf_stride = s;
  cur += nb * s;
  if (stage & STAGE_LODF) {
    float* lodf = cur;
    stage_into(cur, net.lodf, nl * nl);
    q.lodf = lodf;
    cur = lodf + round4(nl * nl);
  } else {
    q.lodf = net.lodf;
  }
  for (int p = threadIdx.x; p < ng; p += blockDim.x) {
    const int u = net.bg_idx[p];
    pmax_at[p] = net.pmax[u];
    list_pos[u] = p;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  return cur;
}

// n bytes from src to dst by the whole block: 16-byte moves where both
// ends are 16-byte aligned (a tile's rows always are, for tensors
// PyTorch allocated), single bytes for the rest.
__device__ __forceinline__ void block_copy(unsigned char* dst,
                                           const unsigned char* src, int n) {
  int done = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const int nv = n >> 4;
    for (int i = threadIdx.x; i < nv; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    done = nv << 4;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Bit i of a 128-bit mask (i uniform over the warp).
__device__ __forceinline__ bool bit_of(const uint32_t m[4], int i) {
  const uint32_t w = i < 64 ? (i < 32 ? m[0] : m[1])
                            : (i < 96 ? m[2] : m[3]);
  return (w >> (i & 31)) & 1u;
}

// m |= v << (32 w') for the word w' = i >> 5 of a 128-bit mask.
__device__ __forceinline__ void or_word(uint32_t m[4], int i, uint32_t v) {
  const int w = i >> 5;
  m[0] |= w == 0 ? v : 0u;
  m[1] |= w == 1 ? v : 0u;
  m[2] |= w == 2 ? v : 0u;
  m[3] |= w == 3 ? v : 0u;
}

// Bits [lo, hi) of word w of a 128-bit mask.
__device__ __forceinline__ uint32_t range_bits(int w, int lo, int hi) {
  const int a = max(lo - 32 * w, 0), b = min(hi - 32 * w, 32);
  if (b <= a) return 0u;
  const uint32_t upto = b == 32 ? 0xffffffffu : (1u << b) - 1u;
  return upto & ~((1u << a) - 1u);
}

// Part r (of split) of the lane's states, drawn: the Philox calls r,
// r + split, ...; their bytes into `bytes` [nc], their bits into m.
__device__ __forceinline__ void sample_mask(uint32_t m[4],
                                            unsigned char* bytes,
                                            const int* seeds,
                                            const int* thresh, int nc,
                                            uint32_t row, int r, int split) {
  m[0] = m[1] = m[2] = m[3] = 0u;
  const int calls = (nc + 3) / 4;
  for (int j = r; j < calls; j += split) {   // components 4j .. 4j + 3
    unsigned char fail[4];
    bernoulli4(seeds, thresh, nc, row, (uint32_t)j, fail);
    uint32_t bits = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bits |= (uint32_t)fail[k] << k;
      if (4 * j + k < nc) bytes[4 * j + k] = fail[k];
    }
    or_word(m, 4 * j, bits << (4 * j & 31));
  }
}

// Part r (of split) of the lane's mask from its explicit state bytes:
// the words w = r, r + split, ... (none when `live` is false: a row
// past the batch).
__device__ __forceinline__ void explicit_mask(uint32_t m[4],
                                              const unsigned char* bytes,
                                              int nc, bool live, int r,
                                              int split) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t word = 0u;
    const int end = live && (w & (split - 1)) == r ? min(32 * w + 32, nc)
                                                   : 0;
#pragma unroll 4
    for (int i = 32 * w; i < end; ++i)
      word |= (uint32_t)(bytes[i] != 0) << (i - 32 * w);
    m[w] = word;
  }
}

// The hint-shaped candidate at the deficit, load j: clip to the load,
// then move the clipped residual into the remaining headroom by the
// lane's factor fc (the up-branch of dcopf._rebalance_shed).
__device__ __forceinline__ float cand_of(const QuickNet& q, int j,
                                         float deficit, float fc) {
  const float ld = q.load[j];
  const float c0 = nmin(q.hint[j] * deficit, ld);
  return nmin(fmaf(ld - c0, fc, c0), ld);
}

// The capacity of the unit at list position p when up (down: the
// lane's outage bits in list order).
__device__ __forceinline__ float gcap_at(const QuickNet& q,
                                         const uint32_t down[4], int p) {
  return bit_of(down, p) ? 0.0f : q.pmax_at[p];
}

// num / d as IEEE division, answering a zero over a finite nonzero d
// directly (+-0 with the quotient's sign): the compiled division takes a
// slow subroutine for a zero numerator, and buses without a load, and
// every lane's candidate when nothing is shed, divide zero.
__device__ __forceinline__ float div_rn(float num, float d) {
  if (num == 0.0f && fabsf(d) < INFINITY && d != 0.0f)
    return d > 0.0f ? num : -num;
  return num / d;
}

// The lane's bus sums s = Cg disp + Cd shed into its column of the
// lanes' [nb][lanes] sums (col[b * lanes]), where disp is the locally
// self-balancing dispatch of dcopf._dispatch_candidate: each bus's units
// cover its post-shed load (the fraction, clipped to 1), then the total
// is rebalanced to the served load (dcopf._rebalance_shed): scaled down,
// or raised in proportion to the headroom. Thread r of the lane's split
// takes the buses r, r + split, ... (the fractions wait in the column);
// the rebalance's two sums over every unit run in every thread, in list
// order, so the split changes no bit.
__device__ __forceinline__ void dispatch_sums(const QuickNet& q,
                                              const uint32_t down[4],
                                              float* col, int lanes,
                                              float deficit, float fc,
                                              int r, int split) {
  const int nb = q.nb;
  for (int b = r; b < nb; b += split) {
    const int u0 = q.bg_ptr[b], u1 = q.bg_ptr[b + 1];
    if (u0 == u1) continue;   // no units: the fraction is never read
    float served = 0.0f, cap = 0.0f;
    for (int p = q.bl_ptr[b]; p < q.bl_ptr[b + 1]; ++p) {
      const int l = q.bl_idx[p];
      served += q.load[l] - cand_of(q, l, deficit, fc);
    }
    for (int p = u0; p < u1; ++p) cap += gcap_at(q, down, p);
    col[b * lanes] = nmin(div_rn(served, nmax(cap, 1e-9f)), 1.0f);
  }
  __syncwarp();
  float total = 0.0f, headroom = 0.0f;
  for (int b = 0; b < nb; ++b) {
    const int u0 = q.bg_ptr[b], u1 = q.bg_ptr[b + 1];
    if (u0 == u1) continue;
    const float frac = col[b * lanes];
    for (int p = u0; p < u1; ++p) {
      const float gc = gcap_at(q, down, p), d0 = gc * frac;
      total += d0;
      headroom += nmax(gc - d0, 0.0f);
    }
  }
  const float served = q.load_tot - deficit;
  const float resid = total - served;
  const float down_scale =
      total > 1e-9f ? div_rn(nmax(served, 0.0f), nmax(total, 1e-9f)) : 0.0f;
  const float up = div_rn(-resid, nmax(headroom, 1e-9f));
  __syncwarp();   // every thread of the lane has read the fractions
  for (int b = r; b < nb; b += split) {
    const int u0 = q.bg_ptr[b], u1 = q.bg_ptr[b + 1];
    float sg = 0.0f, sd = 0.0f;
    if (u0 < u1) {
      const float frac = col[b * lanes];
      for (int p = u0; p < u1; ++p) {
        const float gc = gcap_at(q, down, p), d0 = gc * frac;
        sg += resid >= 0.0f ? d0 * down_scale
                            : nmin(fmaf(nmax(gc - d0, 0.0f), up, d0), gc);
      }
    }
    for (int p = q.bl_ptr[b]; p < q.bl_ptr[b + 1]; ++p)
      sd += cand_of(q, q.bl_idx[p], deficit, fc);
    col[b * lanes] = sg + sd;
  }
  __syncwarp();
}

// The banded post-outage check over the branch chunks r, r + split, ...
// of QUICK_CHUNK branches: flows f_l = sum_b inj_b PTDF[l, b] and S_l =
// sum_b a_b |PTDF[l, b]| (inj = s - load_bus, a = s + load_bus, s the
// lane's bus sums), each by one FMA chain over b in order; then p_l =
// (f_l + fk LODF[l, k]) (1 - [l == k]) against rate_l + 1e-4 - (eps (S_l
// + |f_l|) + bk |LODF[l, k]|). k < 0: no outaged branch.
__device__ __forceinline__ bool flows_clear(const QuickNet& q,
                                            const float* col, int lanes,
                                            int k, float fk, float bk,
                                            float eps, int r, int split) {
  const int nl = q.nl, nb = q.nb, ps = q.ptdf_stride;
  bool clear = true;
  for (int c0 = r * QUICK_CHUNK; c0 < nl; c0 += split * QUICK_CHUNK) {
    float fl[QUICK_CHUNK], sa[QUICK_CHUNK];
#pragma unroll
    for (int i = 0; i < QUICK_CHUNK; ++i) fl[i] = sa[i] = 0.0f;
    for (int b = 0; b < nb; ++b) {
      const float s = col[b * lanes], lb = q.load_bus[b];
      const float inj = s - lb, a = s + lb;
      float p[QUICK_CHUNK];   // one broadcast 16-byte load per four
      const float* row = q.ptdf + b * ps + c0;
#pragma unroll
      for (int i = 0; i < QUICK_CHUNK; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + i);
        p[i] = v.x; p[i + 1] = v.y; p[i + 2] = v.z; p[i + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < QUICK_CHUNK; ++i) {
        fl[i] = fmaf(inj, p[i], fl[i]);
        sa[i] = fmaf(a, fabsf(p[i]), sa[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < QUICK_CHUNK; ++i) {
      const int l = c0 + i;
      if (l < nl) {
        const float lk = k >= 0 ? q.lodf[l * nl + k] : 0.0f;
        const float post = fmaf(fk, lk, fl[i]) * (l == k ? 0.0f : 1.0f);
        const float bnd = fmaf(bk, fabsf(lk), eps * (sa[i] + fabsf(fl[i])));
        clear = clear && !(fabsf(post) > q.rate_ok[l] - bnd);
      }
    }
  }
  return clear;
}

__global__ void __launch_bounds__(QUICK_MAX_THREADS)
quick_kernel(const int* __restrict__ seeds, const int* __restrict__ thresh,
             const unsigned char* __restrict__ down_in,
             const float* __restrict__ fbuf, const int* __restrict__ ibuf,
             int batch, int ng, int nd, int nl, int nb, int stage, float eps,
             unsigned char* __restrict__ down_out,
             unsigned char* __restrict__ ok1, float* __restrict__ deficit_out,
             float* __restrict__ shed_out) {
  extern __shared__ __align__(16) float smem[];
  QuickNet q;
  q.ng = ng; q.nd = nd; q.nl = nl; q.nb = nb;
  float* sums = quick_stage(q, fbuf, ibuf, thresh, stage, smem);  // [nb][L]
  const int split_log = (stage >> QUICK_SPLIT_SHIFT) & 3;
  const int split = 1 << split_log;
  const int lanes = blockDim.x >> split_log, nc = ng + nl;
  const int t = threadIdx.x >> split_log, r = threadIdx.x & (split - 1);
  float* col = sums + t;                                          // lane t
  unsigned char* io = reinterpret_cast<unsigned char*>(sums + nb * lanes);
  float* shed_io = reinterpret_cast<float*>(io);                  // [L][nd]

  for (int b0 = blockIdx.x * lanes; b0 < batch; b0 += gridDim.x * lanes) {
    const int rows = min(lanes, batch - b0), row = b0 + t;
    __syncthreads();   // the previous tile's copies out of io are done

    // States: the mask in registers (each thread of the split draws or
    // reads its part; OR joins them), the bytes out through io.
    uint32_t m[4];
    if (down_in) {
      block_copy(io, down_in + (size_t)b0 * nc, rows * nc);
      __syncthreads();
      explicit_mask(m, io + t * nc, nc, t < rows, r, split);
    } else {
      sample_mask(m, io + t * nc, seeds, q.thresh, nc, (uint32_t)row, r,
                  split);
      __syncthreads();
    }
    for (int o = 1; o < split; o <<= 1)
#pragma unroll
      for (int w = 0; w < 4; ++w) m[w] |= __shfl_xor_sync(~0u, m[w], o);
    block_copy(down_out + (size_t)b0 * nc, io, rows * nc);
    int n_out = 0, k = -1;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t br = m[w] & range_bits(w, ng, nc);
      n_out += __popc(br);
      if (k < 0 && br) k = 32 * w + __ffs(br) - 1 - ng;
    }

    // Exact copper deficit (sum of the lost capacities in unit order),
    // the units' outage bits in list order, and the candidate's factor.
    float lost = 0.0f;
    uint32_t down[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t g = m[w] & range_bits(w, 0, ng);
      for (; g; g &= g - 1u) {
        const int u = 32 * w + __ffs(g) - 1, p = q.list_pos[u];
        lost += q.pmax[u];
        or_word(down, p, 1u << (p & 31));
      }
    }
    const float deficit = nmax(q.load_tot - (q.pmax_tot - lost), 0.0f);
    float tot0 = 0.0f, head = 0.0f;
    for (int j = 0; j < nd; ++j) {
      const float ld = q.load[j], c0 = nmin(q.hint[j] * deficit, ld);
      tot0 += c0;
      head += ld - c0;
    }
    const float fc = div_rn(deficit - tot0, nmax(head, 1e-9f));

    // The shed candidate, out through io.
    __syncthreads();   // the states are out of io
    for (int j = r; j < nd; j += split)
      shed_io[t * nd + j] = cand_of(q, j, deficit, fc);
    __syncthreads();
    block_copy(reinterpret_cast<unsigned char*>(shed_out + (size_t)b0 * nd),
               io, rows * nd * 4);

    dispatch_sums(q, down, col, lanes, deficit, fc, r, split);

    // The outaged branch's flow and bound, by the chain flows_clear
    // runs for it (so bit for bit the same), then the banded check.
    const bool single = n_out == 1;
    float fk = 0.0f, bk = 0.0f;
    if (__any_sync(0xffffffffu, single)) {
      const int kc = single ? k : 0;
      float f = 0.0f, sa = 0.0f;
      for (int b = 0; b < nb; ++b) {
        const float s = col[b * lanes], lb = q.load_bus[b];
        const float p = q.ptdf[b * q.ptdf_stride + kc];
        f = fmaf(s - lb, p, f);
        sa = fmaf(s + lb, fabsf(p), sa);
      }
      if (single) {
        fk = f;
        bk = eps * (sa + fabsf(f));
      }
    }
    int clear = flows_clear(q, col, lanes, single ? k : -1, fk, bk, eps, r,
                            split);
    for (int o = 1; o < split; o <<= 1)
      clear &= __shfl_xor_sync(~0u, clear, o);
    if (r == 0 && row < batch) {
      ok1[row] = clear && n_out <= 1;
      deficit_out[row] = deficit;
    }
  }
}

// Allow the kernel the device's whole opt-in shared memory and the
// largest shared carveout, once per process and device.
inline cudaError_t quick_prepare(int dev) {
  static uint64_t ready = 0;
  if (dev < 64 && (ready >> dev & 1)) return cudaSuccess;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(quick_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(quick_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 64) ready |= 1ull << dev;
  return e;
}

}  // namespace psra

// C interface (bound with ctypes). Random-state mode: seeds int32 [2]
// and thresh int32 [ng + nl] on the device, down_in null. Explicit mode:
// down_in bool [batch, ng + nl], seeds and thresh null. fbuf / ibuf:
// the network buffers of cert_common.cuh followed by the load [nd], the
// hint [nd], the bus load [nb] and (load total, capacity total). stage:
// STAGE_PTDF (required) | STAGE_LODF (LODF in shared memory, else read
// through the cache) | log2 of the threads a lane << QUICK_SPLIT_SHIFT.
// smem_bytes: the block's dynamic shared memory, quick_staged_words
// words plus quick_lane_bytes a lane, which fixes the lanes a block: a
// multiple of 32, at most QUICK_MAX_LANES, with lanes x threads a lane
// <= QUICK_MAX_THREADS (ops/fused_sampler_cert.py::launch_shape chooses
// them; any other size returns cudaErrorInvalidValue). eps: the guard
// band's relative constant. Outputs: down_out bool [batch, ng + nl], ok1
// bool [batch], deficit [batch], shed [batch, nd]. Launches on `stream`,
// allocates nothing, returns the first CUDA error.
extern "C" int psra_fused_sampler_cert(
    const int* seeds, const int* thresh, const unsigned char* down_in,
    const float* fbuf, const int* ibuf, int batch, int ng, int nd, int nl,
    int nb, int stage, int smem_bytes, float eps, unsigned char* down_out,
    unsigned char* ok1, float* deficit, float* shed, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  const int rest =
      smem_bytes - 4 * psra::quick_staged_words(ng, nd, nl, nb, stage);
  const int per_lane = psra::quick_lane_bytes(ng, nd, nl, nb);
  const int lanes = rest > 0 && rest % per_lane == 0 ? rest / per_lane : 0;
  const int threads = lanes << ((stage >> psra::QUICK_SPLIT_SHIFT) & 3);
  if (!(stage & psra::STAGE_PTDF) || lanes == 0 || lanes % 32 != 0 ||
      lanes > psra::QUICK_MAX_LANES || threads > psra::QUICK_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  // Persistent blocks: as many as the card holds at this size, never
  // more than the tiles of `lanes` rows.
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = psra::quick_prepare(dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, psra::quick_kernel, threads, (size_t)smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (batch + lanes - 1) / lanes;
  const int fill = (per_sm > 0 ? per_sm : 1) * sms;
  psra::quick_kernel<<<tiles < fill ? tiles : fill, threads, smem_bytes,
                       (cudaStream_t)stream>>>(
      seeds, thresh, down_in, fbuf, ibuf, batch, ng, nd, nl, nb, stage, eps,
      down_out, ok1, deficit, shed);
  return (int)cudaGetLastError();
}
