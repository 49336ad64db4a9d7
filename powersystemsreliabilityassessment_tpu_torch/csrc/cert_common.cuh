// Shared device code of the two tier-1 certificate kernels: the
// network's buffers (Net, net_unpack, the STAGE_* bits), which both
// read, and the layout of certify_kernel.cu (K5): one warp per state
// lane, the lane's vectors (<= 128 long) spread over the warp's
// registers, the network's matrices in shared memory where they fit.
// fused_sampler_cert.cu (K4) runs one thread per lane on its own code.
//
// Replaces: the per-tile jnp arithmetic of the TPU Pallas kernels
//   powersystemsreliabilityassessment_tpu/ops/certify_kernel.py
//   (_make_kernel, _rebalance) and ops/fused_sampler_cert.py
//   (_make_kernel), which run every product as a [TILE, <=128] x
//   [<=128, <=128] MXU matmul.
//
// What bounds them on an H100: operations. A lane reads ~150-350 bytes
// (its states and load) and writes its shed/dispatch, while its flow
// checks are dense products with the PTDF and LODF matrices (~16 kFLOP
// for K4's first pass, ~62 kFLOP for K5 with three repair steps, RTS-24).
//
// What the design does about it: the one-hot incidence matrices become
// index arrays (a unit's bus; per-bus CSR lists of units and loads), so
// their products are exact gathers and short sums, and the product
// w @ (PTDF Cg) of the repair step is one PTDF product per bus followed
// by a gather. Matrices are staged once per (persistent) block into
// shared memory, or read through the cache when they do not fit. Row
// sums are warp shuffles; lane vectors pass between threads through a
// small per-warp scratch in shared memory.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

#include "common.cuh"

namespace psra {

constexpr int CERT_VR = 4;      // vector slots per thread: lanes <= 128
constexpr int CERT_WARPS = 8;   // state lanes per block

// Loop over a lane vector of length n: slot r of thread `lane` holds
// element j = lane + 32 r. Needs `lane` in scope.
#define CERT_FOR(n)                                                \
  _Pragma("unroll") for (int r = 0, j = lane; r < CERT_VR;         \
                         ++r, j += 32) if (j < (n))

typedef float LaneVec[CERT_VR];

// The System's matrices and index arrays, unpacked from the two device
// buffers the wrappers build (layout in net_unpack).
struct Net {
  int ng, nd, nl, nb;
  const float* ptdfT;     // [nb, nl]: ptdfT[b * nl + l] = PTDF[l, b]
  const float* lodf;      // [nl, nl]: lodf[l * nl + k] = LODF[l, k]
  const float* transfer;  // [nl, nl]: br_transfer, row-major
  const float* pmax;      // [ng]
  const float* rate;      // [nl]
  const float* rate_ok;   // [nl]: rate + 1e-4, rounded once in float32
  const int* gen_bus;     // [ng]: the bus of each unit
  const int* load_bus;    // [nd]: the bus of each load
  const int* bg_ptr;      // [nb + 1]: units at bus b are
  const int* bg_idx;      //   bg_idx[bg_ptr[b] .. bg_ptr[b + 1]), ascending
  const int* bl_ptr;      // [nb + 1]: loads at bus b, likewise
  const int* bl_idx;
};

// Floats: ptdfT, lodf, transfer, pmax, rate, rate_ok, then the kernel's
// own extras. Ints: gen_bus, load_bus, bg_ptr, bg_idx, bl_ptr, bl_idx.
__host__ __device__ __forceinline__ int net_floats(int ng, int nl, int nb) {
  return nb * nl + 2 * nl * nl + ng + 2 * nl;
}

__device__ __forceinline__ Net net_unpack(const float* f, const int* i, int ng,
                                 int nd, int nl, int nb) {
  Net n;
  n.ng = ng; n.nd = nd; n.nl = nl; n.nb = nb;
  n.ptdfT = f;            f += nb * nl;
  n.lodf = f;             f += nl * nl;
  n.transfer = f;         f += nl * nl;
  n.pmax = f;             f += ng;
  n.rate = f;             f += nl;
  n.rate_ok = f;
  n.gen_bus = i;          i += ng;
  n.load_bus = i;         i += nd;
  n.bg_ptr = i;           i += nb + 1;
  n.bg_idx = i;           i += ng;
  n.bl_ptr = i;           i += nb + 1;
  n.bl_idx = i;
  return n;
}

// Bits of `stage`: which matrices the block copies into shared memory.
constexpr int STAGE_PTDF = 1, STAGE_LODF = 2, STAGE_TRANSFER = 4;

// Copy the flagged matrices into shared memory at `smem` (by the whole
// block) and point `net` at the copies; returns the first free float.
__device__ __forceinline__ float* net_stage(Net& net, float* smem, int stage) {
  const int nl = net.nl, nb = net.nb;
  const float** mats[3] = {&net.ptdfT, &net.lodf, &net.transfer};
  const int bits[3] = {STAGE_PTDF, STAGE_LODF, STAGE_TRANSFER};
  const int sizes[3] = {nb * nl, nl * nl, nl * nl};
  for (int m = 0; m < 3; ++m) {
    if (!(stage & bits[m])) continue;
    for (int t = threadIdx.x; t < sizes[m]; t += blockDim.x)
      smem[t] = (*mats[m])[t];
    *mats[m] = smem;
    smem += sizes[m];
  }
  __syncthreads();
  return smem;
}

// Per-warp scratch floats: one unit, one load, two bus and two branch
// vectors.
__host__ __device__ __forceinline__ int cert_scratch(int ng, int nd, int nl, int nb) {
  return ng + nd + 2 * nb + 2 * nl;
}

struct Scratch {
  float *g, *d, *b, *b2, *l, *l2;
};

__device__ __forceinline__ Scratch scratch_at(float* s, const Net& n) {
  Scratch w;
  w.g = s;          s += n.ng;
  w.d = s;          s += n.nd;
  w.b = s;          s += n.nb;
  w.b2 = s;         s += n.nb;
  w.l = s;          s += n.nl;
  w.l2 = s;
  return w;
}

__device__ __forceinline__ float vsum(const LaneVec x, int n) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  CERT_FOR(n) s += x[r];
  return warp_reduce<kSum>(s);
}

__device__ __forceinline__ float vmaxabs(const LaneVec x, int n) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  CERT_FOR(n) s = fmaxf(s, fabsf(x[r]));
  return warp_reduce<kMax>(s);
}

// Lane vector -> per-warp scratch, visible to the whole warp on return.
__device__ __forceinline__ void vstore(float* dst, const LaneVec x, int n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();   // earlier readers of dst are done
  CERT_FOR(n) dst[j] = x[r];
  __syncwarp();
}

// torch.sign semantics (0 at 0).
__device__ __forceinline__ float sgnf(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// Rebalance a nonnegative pattern x to sum `target` within `caps`:
// scale down multiplicatively, or up in proportion to the headroom.
// Mirrors dcopf._rebalance_shed statement for statement.
__device__ __forceinline__ void rebalance(LaneVec x, const LaneVec caps,
                                 float target, int n) {
  const int lane = threadIdx.x & 31;
  const float total = vsum(x, n);
  const float resid = total - target;
  const float down_scale =
      total > 1e-9f ? nmax(target, 0.0f) / nmax(total, 1e-9f) : 0.0f;
  LaneVec head = {0.0f, 0.0f, 0.0f, 0.0f};
  CERT_FOR(n) head[r] = nmax(caps[r] - x[r], 0.0f);
  const float head_tot = nmax(vsum(head, n), 1e-9f);
  const float f = (-resid) / head_tot;
  CERT_FOR(n) {
    const float up = x[r] + head[r] * f;
    x[r] = resid >= 0.0f ? x[r] * down_scale : nmin(up, caps[r]);
  }
}

// out[b] = sum over the units at bus b of g[unit] (g: scratch, or null)
// plus the same over loads of d; the one-hot products Cg g + Cd d.
__device__ __forceinline__ void bus_sums(LaneVec out, const Net& net, const float* g,
                                const float* d) {
  const int lane = threadIdx.x & 31;
  CERT_FOR(net.nb) {
    float sg = 0.0f, sd = 0.0f;
    if (g)
      for (int p = net.bg_ptr[j]; p < net.bg_ptr[j + 1]; ++p)
        sg += g[net.bg_idx[p]];
    if (d)
      for (int p = net.bl_ptr[j]; p < net.bl_ptr[j + 1]; ++p)
        sd += d[net.bl_idx[p]];
    out[r] = sg + sd;
  }
}

// The locally self-balancing dispatch of dcopf._dispatch_candidate: each
// bus's units cover its own post-shed load first, the residual is pooled
// over the remaining headroom. disp = rebalance(gcap * frac[bus], served).
__device__ __forceinline__ void dispatch_candidate(LaneVec disp, const Net& net,
                                          const Scratch& w,
                                          const LaneVec gcap,
                                          const LaneVec load,
                                          const LaneVec cand, float served) {
  const int lane = threadIdx.x & 31;
  LaneVec t = {0.0f, 0.0f, 0.0f, 0.0f};
  CERT_FOR(net.nd) t[r] = load[r] - cand[r];
  vstore(w.d, t, net.nd);
  vstore(w.g, gcap, net.ng);
  LaneVec served_bus, cap_bus;
  bus_sums(served_bus, net, nullptr, w.d);
  bus_sums(cap_bus, net, w.g, nullptr);
  CERT_FOR(net.nb)
    t[r] = nmin(served_bus[r] / nmax(cap_bus[r], 1e-9f), 1.0f);
  vstore(w.b, t, net.nb);
  CERT_FOR(net.ng) disp[r] = gcap[r] * w.b[net.gen_bus[j]];
  rebalance(disp, gcap, served, net.ng);
}

// flows = PTDF ((Cg disp + Cd shed) - load_bus): the bus injections go
// to scratch b; flows[l] = sum_b inj[b] ptdfT[b, l].
__device__ __forceinline__ void flows_of(LaneVec flows, const Net& net,
                                const Scratch& w, const LaneVec disp,
                                const LaneVec shed, const LaneVec load_bus) {
  const int lane = threadIdx.x & 31;
  vstore(w.g, disp, net.ng);
  vstore(w.d, shed, net.nd);
  LaneVec inj;
  bus_sums(inj, net, w.g, w.d);
  CERT_FOR(net.nb) inj[r] = inj[r] - load_bus[r];
  vstore(w.b, inj, net.nb);
  CERT_FOR(net.nl) {
    float s = 0.0f;
    for (int b = 0; b < net.nb; ++b) s = fmaf(w.b[b], net.ptdfT[b * net.nl + j], s);
    flows[r] = s;
  }
}

// The lane's branch outages from its component states (bool bytes in
// scratch-free form: brd(j) = down[ng + j]): per-slot ballot masks, the
// count, and the first two outaged branches (-1 when absent).
struct Outages {
  unsigned mask[CERT_VR];
  int n_out, k0, k1;
};

__device__ __forceinline__ Outages outages_of(const unsigned char* br_down, int nl) {
  const int lane = threadIdx.x & 31;
  Outages o;
  o.n_out = 0;
  o.k0 = o.k1 = -1;
#pragma unroll
  for (int r = 0; r < CERT_VR; ++r) {
    const int j = lane + 32 * r;
    o.mask[r] = __ballot_sync(0xffffffffu, j < nl && br_down[j] != 0);
    unsigned m = o.mask[r];
    o.n_out += __popc(m);
    while (m && o.k1 < 0) {
      const int k = 32 * r + __ffs(m) - 1;
      if (o.k0 < 0) o.k0 = k; else o.k1 = k;
      m &= m - 1;
    }
  }
  return o;
}

__device__ __forceinline__ float brd_of(const Outages& o, int r) {
  return ((o.mask[r] >> (threadIdx.x & 31)) & 1u) ? 1.0f : 0.0f;
}

// Post-outage flows of an intact or single-outage lane (the LODF rank-1
// update, exact for n_out <= 1): post = (f + f_k LODF[:, k]) (1 - brd),
// f_k read through scratch l. Mirrors (f + (brd f) @ LODF') (1 - brd).
__device__ __forceinline__ void post_flows(LaneVec post, const Net& net,
                                  const Scratch& w, const LaneVec f,
                                  const Outages& o) {
  const int lane = threadIdx.x & 31;
  if (o.n_out == 0) {
    CERT_FOR(net.nl) post[r] = f[r];
    return;
  }
  vstore(w.l, f, net.nl);
  const float fk = w.l[o.k0];
  CERT_FOR(net.nl)
    post[r] = (f[r] + fk * net.lodf[j * net.nl + o.k0]) * (1.0f - brd_of(o, r));
}

// all(|post| <= rate + 1e-4) over the lane's branches.
__device__ __forceinline__ bool flows_ok(const LaneVec post, const Net& net) {
  const int lane = threadIdx.x & 31;
  bool ok = true;
  CERT_FOR(net.nl) ok = ok && fabsf(post[r]) <= net.rate_ok[j];
  return __all_sync(0xffffffffu, ok);
}

// Launch geometry of a persistent certificate kernel: enough blocks to
// fill the card at the occupancy `kernel` reaches with `smem` bytes,
// never more than the lanes need. Sets the dynamic shared-memory limit.
template <typename K>
inline cudaError_t cert_grid(K kernel, int batch, size_t smem, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, CERT_WARPS * 32, smem)) != cudaSuccess)
    return e;
  const int need = (batch + CERT_WARPS - 1) / CERT_WARPS;
  const int fill = (per_sm > 0 ? per_sm : 1) * sms;
  *grid = need < fill ? need : fill;
  return cudaSuccess;
}

}  // namespace psra
