// Device code of the two thread-a-lane certificate kernels, K4
// (fused_sampler_cert.cu) and K5 (certify_kernel.cu): one thread (or a
// split of 2-8 neighbouring threads of a warp) owns a state lane.
//
// Replaces: the per-tile jnp arithmetic the TPU Pallas kernels share,
//   powersystemsreliabilityassessment_tpu/ops/fused_sampler_cert.py
//   (_make_kernel) and ops/certify_kernel.py (_make_kernel,
//   _rebalance), where every product is a [TILE, <=128] x [<=128,
//   <=128] MXU matmul.
//
// What bounds them on an H100: operations (a lane's flow check is a
// [nb] x [nb, nl] product) and the latency of their sequential sums.
//
// What the design does about it:
// - a lane's 128-bit outage mask lives in registers; its unit and branch
//   outages come out of it by __popc / __ffs;
// - sums over units and loads run in the network's per-bus list order,
//   sequentially, in every thread of a lane's split, so the split
//   changes no bit; a lane keeps one vector, its bus sums, in a shared
//   column laid out [bus][lane] (no bank conflicts);
// - flows are streamed over chunks of FLOW_CHUNK branches held in
//   registers, each PTDF row read as broadcast 16-byte loads, each
//   branch checked and dropped (stream_flows);
// - tiles of rows move between device and shared memory as aligned
//   16-byte pieces (block_copy).
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

#include "common.cuh"

namespace psra {

constexpr int FLOW_CHUNK = 8;   // branches a flow pass carries

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// PTDF's row stride in shared memory: nl rounded up to the chunk.
__host__ __device__ __forceinline__ int flow_ptdf_stride(int nl) {
  return (nl + FLOW_CHUNK - 1) / FLOW_CHUNK * FLOW_CHUNK;
}

// Start an asynchronous 4-byte copy from device to shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Wait for every cp.async of this thread, then for the whole block.
__device__ __forceinline__ void cp_async_wait_block() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
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

// PTDF transposed ([nb][nl] at src) into shared rows of
// flow_ptdf_stride(nl) floats, the padding zeroed, by the whole block.
__device__ __forceinline__ void stage_ptdf(float* dst, const float* src,
                                           int nl, int nb) {
  const int s = flow_ptdf_stride(nl);
  for (int b = 0; b < nb; ++b)
    for (int l = threadIdx.x; l < s; l += blockDim.x) {
      if (l < nl) cp_async4(dst + b * s + l, src + b * nl + l);
      else dst[b * s + l] = 0.0f;   // the chunk's spare columns
    }
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

// `rows` rows of `width` floats from src (row stride src_stride) to dst
// (row stride dst_stride), by the whole block: one block_copy where both
// strides are the width, else word by word (a padded shared stride).
__device__ __forceinline__ void rows_copy(float* dst, int dst_stride,
                                          const float* src, int src_stride,
                                          int rows, int width) {
  if (dst_stride == width && src_stride == width) {
    block_copy(reinterpret_cast<unsigned char*>(dst),
               reinterpret_cast<const unsigned char*>(src),
               4 * rows * width);
    return;
  }
  for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
    const int row = i / width, col = i - row * width;
    dst[row * dst_stride + col] = src[row * src_stride + col];
  }
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

// Part r (of split) of the lane's mask from its explicit state bytes:
// the words w = r, r + split, ... (none when `live` is false: a row
// past the batch). The split's threads OR their parts together.
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

// OR the mask over the lane's split (threads r ^ o of `sync_mask`).
__device__ __forceinline__ void join_mask(uint32_t m[4], int split,
                                          unsigned sync_mask) {
  for (int o = 1; o < split; o <<= 1)
#pragma unroll
    for (int w = 0; w < 4; ++w) m[w] |= __shfl_xor_sync(sync_mask, m[w], o);
}

// The lane's branch outages: their count and the first two (branch
// index, -1 when absent), from the mask's bits ng .. nc - 1.
__device__ __forceinline__ void branch_outages(const uint32_t m[4], int ng,
                                               int nc, int& n_out, int& k0,
                                               int& k1) {
  n_out = 0;
  k0 = k1 = -1;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t br = m[w] & range_bits(w, ng, nc);
    n_out += __popc(br);
    for (; br && k1 < 0; br &= br - 1u) {
      const int k = 32 * w + __ffs(br) - 1 - ng;
      if (k0 < 0) k0 = k; else k1 = k;
    }
  }
}

// The capacity the lane's down units take (their pmax summed in unit
// order), and their outage bits in unit-list order (down, zeroed here).
__device__ __forceinline__ float unit_outages(const uint32_t m[4], int ng,
                                              const float* pmax,
                                              const int* list_pos,
                                              uint32_t down[4]) {
  float lost = 0.0f;
  down[0] = down[1] = down[2] = down[3] = 0u;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t g = m[w] & range_bits(w, 0, ng);
    for (; g; g &= g - 1u) {
      const int u = 32 * w + __ffs(g) - 1, p = list_pos[u];
      lost += pmax[u];
      or_word(down, p, 1u << (p & 31));
    }
  }
  return lost;
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

// The network's per-bus lists, as the lanes read them (shared copies).
struct BusLists {
  int nb, ng;
  const int* bg_ptr;     // [nb + 1]: units at bus b are list positions
                         //   bg_ptr[b] .. bg_ptr[b + 1] - 1
  const float* pmax_at;  // [ng]: capacity of the unit at list position p
  const int* bl_ptr;     // [nb + 1]: loads at bus b are
  const int* bl_idx;     //   bl_idx[bl_ptr[b] .. bl_ptr[b + 1])
  const int* pos_bus;    // [ng]: the bus of list position p (L::kParts)
};

// Sums of a lane's vectors as SUM_PARTS interleaved accumulators
// (element i in part i % SUM_PARTS), combined in part order: the same
// bits in every thread of a split, and a dependence chain SUM_PARTS
// times shorter than one sequential sum.
constexpr int SUM_PARTS = 8;

__device__ __forceinline__ float combine_parts(const float a[SUM_PARTS]) {
  float t = a[0];
#pragma unroll
  for (int k = 1; k < SUM_PARTS; ++k) t += a[k];
  return t;
}

// The capacity of the unit at list position p when up (down: the
// lane's outage bits in list order).
__device__ __forceinline__ float gcap_at(const BusLists& g,
                                         const uint32_t down[4], int p) {
  return bit_of(down, p) ? 0.0f : g.pmax_at[p];
}

// The lane's bus sums into its column of the lanes' [nb][lanes] sums
// (col[b * lanes]) for the locally self-balancing dispatch of
// dcopf._dispatch_candidate: each bus's units cover its post-shed load
// (the fraction, clipped to 1), then the total is rebalanced to
// `served` (dcopf._rebalance_shed): scaled down, or raised in proportion
// to the headroom. The lane policy L gives the load l (load(l)), its
// shed candidate (cand(l)), takes each unit's dispatch (unit(p, v), p
// its list position), and says what the column keeps: Cg disp + Cd shed,
// or with L::kInj the injection (Cg disp + Cd shed) - Cd load; with
// L::kParts the rebalance's sums run in SUM_PARTS parts (else each is
// one sequential sum, as K4's bits were first computed). Thread r
// of the lane's split takes the buses r, r + split, ... (the fractions
// wait in the column); the rebalance's two sums over every unit run in
// every thread, in list order, so the split changes no bit. sync_mask:
// the threads that run this together (a warp, or the lane's split).
template <class L>
__device__ __forceinline__ void dispatch_pass(const BusLists& g,
                                              const uint32_t down[4],
                                              float* col, int lanes,
                                              float served, const L& lane,
                                              int r, int split,
                                              unsigned sync_mask) {
  const int nb = g.nb;
  for (int b = r; b < nb; b += split) {
    const int u0 = g.bg_ptr[b], u1 = g.bg_ptr[b + 1];
    if (u0 == u1) continue;   // no units: the fraction is never read
    float srv = 0.0f, cap = 0.0f;
    for (int p = g.bl_ptr[b]; p < g.bl_ptr[b + 1]; ++p) {
      const int l = g.bl_idx[p];
      srv += lane.load(l) - lane.cand(l);
    }
    for (int p = u0; p < u1; ++p) cap += gcap_at(g, down, p);
    col[b * lanes] = nmin(div_rn(srv, nmax(cap, 1e-9f)), 1.0f);
  }
  __syncwarp(sync_mask);
  float total = 0.0f, headroom = 0.0f;
  if constexpr (L::kParts) {   // every unit in list order, in parts
    float tp[SUM_PARTS], hp[SUM_PARTS];
#pragma unroll
    for (int k = 0; k < SUM_PARTS; ++k) tp[k] = hp[k] = 0.0f;
    for (int p0 = 0; p0 < g.ng; p0 += SUM_PARTS) {
#pragma unroll
      for (int k = 0; k < SUM_PARTS; ++k) {
        const int p = p0 + k;
        if (p < g.ng) {
          const float gc = gcap_at(g, down, p);
          const float d0 = gc * col[g.pos_bus[p] * lanes];
          tp[k] += d0;
          hp[k] += nmax(gc - d0, 0.0f);
        }
      }
    }
    total = combine_parts(tp);
    headroom = combine_parts(hp);
  } else {
    for (int b = 0; b < nb; ++b) {
      const int u0 = g.bg_ptr[b], u1 = g.bg_ptr[b + 1];
      if (u0 == u1) continue;
      const float frac = col[b * lanes];
      for (int p = u0; p < u1; ++p) {
        const float gc = gcap_at(g, down, p), d0 = gc * frac;
        total += d0;
        headroom += nmax(gc - d0, 0.0f);
      }
    }
  }
  const float resid = total - served;
  const float down_scale =
      total > 1e-9f ? div_rn(nmax(served, 0.0f), nmax(total, 1e-9f)) : 0.0f;
  const float up = div_rn(-resid, nmax(headroom, 1e-9f));
  __syncwarp(sync_mask);   // every thread of the lane has read the fractions
  for (int b = r; b < nb; b += split) {
    const int u0 = g.bg_ptr[b], u1 = g.bg_ptr[b + 1];
    float sg = 0.0f, sd = 0.0f, sl = 0.0f;
    if (u0 < u1) {
      const float frac = col[b * lanes];
      for (int p = u0; p < u1; ++p) {
        const float gc = gcap_at(g, down, p), d0 = gc * frac;
        const float v = resid >= 0.0f
                            ? d0 * down_scale
                            : nmin(fmaf(nmax(gc - d0, 0.0f), up, d0), gc);
        lane.unit(p, v);
        sg += v;
      }
    }
    for (int p = g.bl_ptr[b]; p < g.bl_ptr[b + 1]; ++p) {
      const int l = g.bl_idx[p];
      sd += lane.cand(l);
      if constexpr (L::kInj) sl += lane.load(l);
    }
    if constexpr (L::kInj) col[b * lanes] = (sg + sd) - sl;
    else col[b * lanes] = sg + sd;
  }
  __syncwarp(sync_mask);
}

// The flow of branch k from the lane's column, by the FMA chain over b
// in order that stream_flows runs for every branch (so bit for bit the
// same). kBand: the column holds bus sums s, the injection is s - lb_b
// and sa = sum_b (s + lb_b) |PTDF[k, b]| is the rounding bound's sum;
// else the column holds the injections and sa stays 0.
template <bool kBand>
__device__ __forceinline__ void flow_at(const float* ptdf, int ps, int nb,
                                        const float* col, int lanes,
                                        const float* lbus, int k, float& f,
                                        float& sa) {
  f = sa = 0.0f;
  for (int b = 0; b < nb; ++b) {
    const float s = col[b * lanes];
    const float p = ptdf[b * ps + k];
    if constexpr (kBand) {
      const float lb = lbus[b];
      f = fmaf(s - lb, p, f);
      sa = fmaf(s + lb, fabsf(p), sa);
    } else {
      f = fmaf(s, p, f);
    }
  }
}

// The lane's flows over the branch chunks r, r + split, ... of
// FLOW_CHUNK branches: f_l = sum_b inj_b PTDF[l, b] (and with kBand the
// bound's sum, as flow_at), each by one FMA chain over b in order; each
// branch goes to tail(l, f_l, sa_l), which returns whether it passes.
// Returns whether every branch of this thread passed.
template <bool kBand, class Tail>
__device__ __forceinline__ bool stream_flows(const float* ptdf, int ps,
                                             int nl, int nb,
                                             const float* col, int lanes,
                                             const float* lbus, int r,
                                             int split, const Tail& tail) {
  bool clear = true;
  for (int c0 = r * FLOW_CHUNK; c0 < nl; c0 += split * FLOW_CHUNK) {
    float fl[FLOW_CHUNK], sa[FLOW_CHUNK];
#pragma unroll
    for (int i = 0; i < FLOW_CHUNK; ++i) fl[i] = sa[i] = 0.0f;
    for (int b = 0; b < nb; ++b) {
      const float s = col[b * lanes];
      float inj = s, a = 0.0f;
      if constexpr (kBand) {
        const float lb = lbus[b];
        inj = s - lb;
        a = s + lb;
      }
      float p[FLOW_CHUNK];   // one broadcast 16-byte load per four
      const float* row = ptdf + b * ps + c0;
#pragma unroll
      for (int i = 0; i < FLOW_CHUNK; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + i);
        p[i] = v.x; p[i + 1] = v.y; p[i + 2] = v.z; p[i + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < FLOW_CHUNK; ++i) {
        fl[i] = fmaf(inj, p[i], fl[i]);
        if constexpr (kBand) sa[i] = fmaf(a, fabsf(p[i]), sa[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < FLOW_CHUNK; ++i) {
      const int l = c0 + i;
      if (l < nl) {
        const bool ok = tail(l, fl[i], sa[i]);
        clear = clear && ok;
      }
    }
  }
  return clear;
}

// torch.sign semantics (0 at 0).
__device__ __forceinline__ float sgnf(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// max(m, v) that keeps a NaN from either side (torch.amax semantics).
__device__ __forceinline__ float amax_nan(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// AND of a flag over the lane's split.
__device__ __forceinline__ bool split_all(bool v, int split,
                                          unsigned sync_mask) {
  int x = v;
  for (int o = 1; o < split; o <<= 1) x &= __shfl_xor_sync(sync_mask, x, o);
  return x != 0;
}

}  // namespace psra
