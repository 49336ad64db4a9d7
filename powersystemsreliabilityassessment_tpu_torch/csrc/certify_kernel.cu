// The whole tier-1 certificate per state lane (K5): copper deficit,
// load-proportional shed candidate, locally balanced dispatch, the LODF
// rank-1 post-outage flow check, up to `repair_iters` flow-repair steps
// and the rank-2 Woodbury check for double branch outages.
//
// Replaces: the TPU Pallas kernel of
//   powersystemsreliabilityassessment_tpu/ops/certify_kernel.py —
//   certify_states_fused (body _make_kernel), which mirrors
//   engines/dcopf.py::certify_states(woodbury_k=2) on [TILE, <=128]
//   tiles with every product an MXU matmul.
//
// What bounds it on an H100: bytes, by the count of chip_smoke.py
// (states and loads in, shed and dispatch out: ~350 a RTS-24 lane, 0.027
// ms at 262,144 lanes); its float32 work (a [nb] x [nb, nl] flow product
// a lane, a gradient product and another flow check a repair step) is
// less. In practice each lane is a chain of dependent shared-memory
// loads and sums, so latency and issue decide its time (PERF.md §6).
//
// What the design does about it (lane_common.cuh, shared with K4):
// - First pass, one thread per state lane (or 2-8 neighbouring threads
//   of a warp when the batch is small: they share its buses and branch
//   chunks and repeat its sums, so every split gives the same bits). A
//   tile of lanes reads its states and loads into shared memory as
//   coalesced 16-byte pieces; the lane's outage masks (units and
//   branches, 128 bits each) sit in registers; the candidate and the
//   dispatch are functions of a few scalars of the lane, recomputed where
//   needed, and their sums run as eight interleaved partial sums (short
//   chains); the lane's bus injections are one shared column laid out
//   [bus][lane]; the flows are streamed in chunks of branches and
//   checked branch by branch (rank-1 LODF update, or the rank-2
//   Woodbury update with the transfer matrix's two columns). Shed and
//   dispatch leave through shared memory as coalesced stores.
// - Repair, for the lanes whose first check fails (~7% of plain Monte
//   Carlo RTS-24 lanes): a thread repairing its lane in place would hold
//   its warp's other 31 lanes for three repair steps, so the first pass
//   lists the lane's row in a device list (a ballot and one atomic a
//   warp) and a second kernel, over a persistent grid that reads the
//   list's count on the device, repairs up to 32 listed lanes at a time
//   a block (the list spread evenly over the grid): each lane taken by
//   four neighbouring threads, more (up to a warp) when fewer lanes are
//   left, its vectors (dispatch, shed, load, post-outage flows /
//   gradient weights, the outaged branch's LODF column, bus injections)
//   in shared memory, each slot's contiguous at a stride that spreads the
//   round's threads over the 32 banks. Its sums run as eight interleaved
//   partial sums combined in order: the same bits for any number of
//   threads. The slot reads the lane's candidate shed, dispatch and
//   deficit back from the first pass's outputs (an earlier launch on the
//   same stream), rebuilds its injections and post-outage flows, then
//   runs the descent of dcopf._repair_descent, stopping at the first
//   step that passes, whose shed and dispatch it writes over the
//   candidate.
// - Matrices: PTDF (rows padded to the chunk) always in shared memory;
//   LODF and the transfer matrix where the wrapper's plan stages them
//   (ops/certify_kernel.py::launch_shape), else read through L2.

#include <stdint.h>

#include "cert_common.cuh"
#include "lane_common.cuh"

namespace psra {

constexpr int CERT_MAX_LANES = 128;     // state lanes a block (32 to 128)
constexpr int CERT_MAX_THREADS = 256;   // lanes x threads a lane
constexpr int REPAIR_SLOTS = 32;        // lanes a repair round takes
constexpr int REPAIR_THREADS = 128;     // threads a repair block
// Bits of `stage` beyond STAGE_*: log2 of the threads a lane (1, 2, 4
// or 8) from bit 8; lanes a block / 32 - 1 from bit 12.
constexpr int CERT_SPLIT_SHIFT = 8;
constexpr int CERT_LANES_SHIFT = 12;

// The shared-memory plan, mirrored by ops/certify_kernel.py.

// Words of the network's small vectors: pmax in unit order and in list
// order, each unit's list position, each list position's bus, the
// list's units, each unit's bus [ng each]; each load's bus [nd]; rate
// and rate + 1e-4 [nl each]; the list pointers (bg_ptr, bl_ptr [nb + 1
// each]) and load indices [nd].
__host__ __device__ __forceinline__ int cert_small_words(int ng, int nd,
                                                         int nl, int nb) {
  return round4(6 * ng + 2 * nd + 2 * nl + 2 * nb + 2);
}

// Row strides of a lane's load (shed) and dispatch rows in shared
// memory: odd, so that the lanes of a warp reading their own rows at
// one index hit 32 different banks.
__host__ __device__ __forceinline__ int cert_load_stride(int nd) {
  return nd | 1;
}
__host__ __device__ __forceinline__ int cert_disp_stride(int ng) {
  return ng | 1;
}

// Words a lane takes in a tile: its bus injections [nb], its load row
// (then its shed), and the exchange region its state bytes [nc] and
// then its dispatch pass through.
__host__ __device__ __forceinline__ int cert_lane_words(int ng, int nd,
                                                        int nl, int nb) {
  const int xw = (ng + nl + 3) / 4, ds = cert_disp_stride(ng);
  return nb + cert_load_stride(nd) + (xw > ds ? xw : ds);
}

// Words a repair slot takes: dispatch [ng], shed and load [nd each],
// post-outage flows or gradient weights and the outaged branch's LODF
// column [nl each], bus gradient or injections [nb], and two rows of
// partial sums [8 each].
__host__ __device__ __forceinline__ int cert_repair_words(int ng, int nd,
                                                          int nl, int nb) {
  return ng + 2 * nd + 2 * nl + nb + 16;
}

// Words the matrices take in shared memory for `stage`: the small
// vectors, PTDF, and LODF and the transfer matrix where flagged.
__host__ __device__ __forceinline__ int cert_staged_words(int ng, int nd,
                                                          int nl, int nb,
                                                          int stage) {
  const int sq = round4(nl * nl);
  return cert_small_words(ng, nd, nl, nb) + nb * flow_ptdf_stride(nl) +
         ((stage & STAGE_LODF) ? sq : 0) + ((stage & STAGE_TRANSFER) ? sq : 0);
}

// The first pass's dynamic shared bytes for `stage` (which carries the
// lanes a block): the matrices and a tile's lanes.
__host__ __device__ __forceinline__ int cert_smem_bytes(int ng, int nd,
                                                        int nl, int nb,
                                                        int stage) {
  const int lanes = (((stage >> CERT_LANES_SHIFT) & 3) + 1) * 32;
  return 4 * (cert_staged_words(ng, nd, nl, nb, stage) +
              lanes * cert_lane_words(ng, nd, nl, nb));
}

// The repair's dynamic shared bytes: the matrices and REPAIR_SLOTS
// slots, each padded by up to 31 words (repair_kernel).
__host__ __device__ __forceinline__ int cert_repair_smem_bytes(int ng, int nd,
                                                               int nl, int nb,
                                                               int stage) {
  return 4 * (cert_staged_words(ng, nd, nl, nb, stage) +
              REPAIR_SLOTS * (cert_repair_words(ng, nd, nl, nb) + 31));
}

// The network as the lanes read it: shared copies, and LODF / the
// transfer matrix in device memory where they are not staged.
struct CertNet {
  int ng, nd, nl, nb;
  const float* pmax;       // [ng], unit order
  const int* list_pos;     // [ng]: unit u is at list_pos[u]
  const int* bg_idx;       // [ng]: the unit at list position p
  const int* gen_bus;      // [ng]
  const int* load_bus;     // [nd]
  const float *rate, *rate_ok;
  BusLists lists;
  const float* ptdf;       // [nb][ps]: PTDF[l, b]
  int ps;
  const float* lodf;       // [nl][nl]
  const float* tr;         // [nl][nl]: br_transfer
  float pmax_tot;
};

// Copy the vectors and the flagged matrices into shared memory by the
// whole block, every copy in flight at once. Returns the first word
// after them.
__device__ __forceinline__ float* cert_stage(CertNet& c, const float* fbuf,
                                             const int* ibuf, int stage,
                                             float* smem) {
  const int ng = c.ng, nd = c.nd, nl = c.nl, nb = c.nb;
  const Net net = net_unpack(fbuf, ibuf, ng, nd, nl, nb);
  c.pmax_tot = fbuf[net_floats(ng, nl, nb)];   // the extra: sum of pmax
  float* cur = smem;
  c.pmax = stage_into(cur, net.pmax, ng);
  float* pmax_at = cur;
  int* list_pos = reinterpret_cast<int*>(cur + ng);
  int* pos_bus = list_pos + ng;
  c.lists.pmax_at = pmax_at;
  c.lists.pos_bus = pos_bus;
  c.list_pos = list_pos;
  cur += 3 * ng;
  c.bg_idx = stage_into(cur, net.bg_idx, ng);
  c.gen_bus = stage_into(cur, net.gen_bus, ng);
  c.load_bus = stage_into(cur, net.load_bus, nd);
  c.rate = stage_into(cur, net.rate, nl);
  c.rate_ok = stage_into(cur, net.rate_ok, nl);
  c.lists.nb = nb;
  c.lists.ng = ng;
  c.lists.bg_ptr = stage_into(cur, net.bg_ptr, nb + 1);
  c.lists.bl_ptr = stage_into(cur, net.bl_ptr, nb + 1);
  c.lists.bl_idx = stage_into(cur, net.bl_idx, nd);
  cur = smem + cert_small_words(ng, nd, nl, nb);
  stage_ptdf(cur, net.ptdfT, nl, nb);
  c.ptdf = cur;
  c.ps = flow_ptdf_stride(nl);
  cur += nb * c.ps;
  c.lodf = net.lodf;
  c.tr = net.transfer;
  if (stage & STAGE_LODF) {
    c.lodf = cur;
    stage_into(cur, net.lodf, nl * nl);
    cur = const_cast<float*>(c.lodf) + round4(nl * nl);
  }
  if (stage & STAGE_TRANSFER) {
    c.tr = cur;
    stage_into(cur, net.transfer, nl * nl);
    cur = const_cast<float*>(c.tr) + round4(nl * nl);
  }
  for (int p = threadIdx.x; p < ng; p += blockDim.x) {
    const int u = net.bg_idx[p];
    pmax_at[p] = net.pmax[u];
    list_pos[u] = p;
    pos_bus[p] = net.gen_bus[u];
  }
  cp_async_wait_block();
  return cur;
}

// The lane's outage masks from its state bytes (units [ng], then
// branches [nl]): units and branches apart, so that each may take up to
// 128 (RTS-96: 99 units and 119 branches). Joined over the split.
__device__ __forceinline__ void lane_masks(uint32_t gm[4], uint32_t bm[4],
                                           const unsigned char* bytes,
                                           int ng, int nl, bool live, int r,
                                           int split, unsigned sync_mask) {
  explicit_mask(gm, bytes, ng, live, r, split);
  explicit_mask(bm, bytes + ng, nl, live, r, split);
  join_mask(gm, split, sync_mask);
  join_mask(bm, split, sync_mask);
}

// A lane's load-proportional shed candidate at its deficit, rebalanced
// (dcopf._shed_candidate with no hint): c0_j = min(load_j frac, load_j),
// then scaled down (resid >= 0) or raised into the headroom by `up`.
struct Cand {
  float load_tot, deficit, frac, resid, down_scale, up;
  __device__ __forceinline__ float operator()(float lp) const {
    const float c0 = nmin(lp * frac, lp);
    return resid >= 0.0f ? c0 * down_scale
                         : nmin(fmaf(nmax(lp - c0, 0.0f), up, c0), lp);
  }
};

// The lane's total load (ld[j * step], j < nd), and its candidate from
// its load row and the capacity of its up units; their sums in
// SUM_PARTS parts, the same in every thread.
__device__ __forceinline__ float load_total(const float* ld, int step,
                                            int nd) {
  float a[SUM_PARTS];
#pragma unroll
  for (int k = 0; k < SUM_PARTS; ++k) a[k] = 0.0f;
  for (int j0 = 0; j0 < nd; j0 += SUM_PARTS)
#pragma unroll
    for (int k = 0; k < SUM_PARTS; ++k)
      if (j0 + k < nd) a[k] += ld[(j0 + k) * step];
  return combine_parts(a);
}

__device__ __forceinline__ Cand cand_of_lane(const float* ld, int step,
                                             int nd, float cap) {
  Cand c;
  float a[SUM_PARTS], h[SUM_PARTS];
  const float tot = load_total(ld, step, nd);
  c.load_tot = tot;
  c.deficit = nmax(tot - cap, 0.0f);
  c.frac = div_rn(c.deficit, nmax(tot, 1e-9f));
#pragma unroll
  for (int k = 0; k < SUM_PARTS; ++k) a[k] = h[k] = 0.0f;
  for (int j0 = 0; j0 < nd; j0 += SUM_PARTS)
#pragma unroll
    for (int k = 0; k < SUM_PARTS; ++k)
      if (j0 + k < nd) {
        const float lp = ld[(j0 + k) * step], c0 = nmin(lp * c.frac, lp);
        a[k] += c0;
        h[k] += nmax(lp - c0, 0.0f);
      }
  const float total = combine_parts(a);
  c.resid = total - c.deficit;
  c.down_scale = total > 1e-9f
                     ? div_rn(nmax(c.deficit, 0.0f), nmax(total, 1e-9f))
                     : 0.0f;
  c.up = div_rn(-c.resid, nmax(combine_parts(h), 1e-9f));
  return c;
}

// K5's lane for dispatch_pass: its own load row (ld[l * ld_step]), the
// candidate above, each unit's dispatch written at disp[u * disp_step];
// the column keeps the bus injections.
struct CertLane {
  static constexpr bool kInj = true, kParts = true;
  const float* ld;
  int ld_step;
  const Cand& cand_fn;
  float* disp;
  int disp_step;
  const int* bg_idx;
  __device__ __forceinline__ float load(int l) const {
    return ld[l * ld_step];
  }
  __device__ __forceinline__ float cand(int l) const {
    return cand_fn(ld[l * ld_step]);
  }
  __device__ __forceinline__ void unit(int p, float v) const {
    disp[bg_idx[p] * disp_step] = v;
  }
};

// The post-outage check of one branch against rate + 1e-4: mode 0
// intact, 1 a single outage k0 (p = (f + a0 M0[l]) (1 - [l == k0]), M0
// the LODF column of k0), 2 two outages (p = (f + (a0 M0[l] + a1
// M1[l])) (1 - brd_l), M0 and M1 the transfer matrix's columns of k0 and
// k1: the Woodbury update). Column entry l is at m[l * step]. Stores p
// at store[l * store_step] when `store` is set.
struct CertTail {
  const float* rate_ok;
  int mode, k0, k1;
  float a0, a1;
  const float *m0, *m1;
  int step;
  float* store;
  int store_step;
  __device__ __forceinline__ bool operator()(int l, float fl, float) const {
    float post = fl;
    if (mode == 1) {
      post = fmaf(a0, m0[l * step], fl) * (l == k0 ? 0.0f : 1.0f);
    } else if (mode == 2) {
      post = (fl + (a0 * m0[l * step] + a1 * m1[l * step])) *
             (l == k0 || l == k1 ? 0.0f : 1.0f);
    }
    if (store) store[l * store_step] = post;
    return fabsf(post) <= rate_ok[l];
  }
};

// The repair's sums over a lane's units, loads or branches run as
// SUM_PARTS interleaved partial sums (element u in part u % SUM_PARTS),
// each sequential, combined in part order: a chain SUM_PARTS times
// shorter than one sequential sum, and the same bits for every group
// size. Thread r of the group takes parts r, r + split, ...; the parts
// meet in the slot's scratch `parts` (SUM_PARTS words a sum).
// (sum of a(u), sum of b(u)) over u < n; `both` holds the two pairs of
// sums f returns as a float2.
template <class F>
__device__ __forceinline__ float2 group_sums(const F& f, int n, float* parts,
                                             int r, int split,
                                             unsigned sync_mask) {
  for (int k = r; k < SUM_PARTS; k += split) {
    float a = 0.0f, b = 0.0f;
#pragma unroll 4
    for (int u = k; u < n; u += SUM_PARTS) {
      const float2 v = f(u);
      a += v.x;
      b += v.y;
    }
    parts[k] = a;
    parts[SUM_PARTS + k] = b;
  }
  __syncwarp(sync_mask);
  float2 t = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < SUM_PARTS; ++k) {
    t.x += parts[k];
    t.y += parts[SUM_PARTS + k];
  }
  __syncwarp(sync_mask);   // every thread has read the parts
  return t;
}

// The largest of f(u), u < n, NaN kept (torch.amax): order-free.
template <class F>
__device__ __forceinline__ float group_max(const F& f, int n, float* parts,
                                           int r, int split,
                                           unsigned sync_mask) {
  for (int k = r; k < SUM_PARTS; k += split) {
    float m = 0.0f;
#pragma unroll 4
    for (int u = k; u < n; u += SUM_PARTS) m = amax_nan(m, f(u));
    parts[k] = m;
  }
  __syncwarp(sync_mask);
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < SUM_PARTS; ++k) m = amax_nan(m, parts[k]);
  __syncwarp(sync_mask);
  return m;
}

// Rebalance the vector x_u = f(u) (u < n, caps cap(u)) to sum `target`
// (dcopf._rebalance_shed); thread r of the group writes its entries to
// out[u * step]. f may read out.
template <class F, class C>
__device__ __forceinline__ void rebalance_into(float* out, int step, int n,
                                               float target, const F& f,
                                               const C& cap, float* parts,
                                               int r, int split,
                                               unsigned sync_mask) {
  const float2 th = group_sums(
      [&](int u) {
        const float x = f(u);
        return make_float2(x, nmax(cap(u) - x, 0.0f));
      },
      n, parts, r, split, sync_mask);
  const float total = th.x, resid = total - target;
  const float down_scale =
      total > 1e-9f ? div_rn(nmax(target, 0.0f), nmax(total, 1e-9f)) : 0.0f;
  const float up = div_rn(-resid, nmax(th.y, 1e-9f));
  for (int u = r; u < n; u += split) {
    const float x = f(u), cu = cap(u);
    out[u * step] = resid >= 0.0f
                        ? x * down_scale
                        : nmin(fmaf(nmax(cu - x, 0.0f), up, x), cu);
  }
  __syncwarp(sync_mask);
}

// The step along the centred gradient g(u) - mean, u < n, that moves
// `amount`: (mean, amount / max(max |g - mean|, 1e-9)).
template <class G>
__device__ __forceinline__ float2 centred_step(const G& g, int n,
                                               float amount, float* parts,
                                               int r, int split,
                                               unsigned sync_mask) {
  const float mean =
      group_sums([&](int u) { return make_float2(g(u), 0.0f); }, n, parts,
                 r, split, sync_mask).x / (float)n;
  const float mx = group_max([&](int u) { return fabsf(g(u) - mean); }, n,
                             parts, r, split, sync_mask);
  return make_float2(mean, div_rn(amount, nmax(mx, 1e-9f)));
}

// Repair lane `row` in its slot's words (`slot`) by the threads r <
// split of its group (sync_mask): stage its load row, its outaged
// branch's LODF column and the first pass's candidate, rebuild its
// post-outage flows, then run up to repair_iters steps of
// dcopf._repair_descent; the first step whose post-outage flows pass
// writes its shed and dispatch and certifies the lane.
__device__ void repair_lane(const CertNet& c, float* slot, int r,
                            int split, unsigned sync_mask, int row,
                            const unsigned char* __restrict__ down_in,
                            const float* __restrict__ load, int repair_iters,
                            const float* deficit_out, unsigned char* cert,
                            float* shed_out, float* disp_out) {
  const int ng = c.ng, nd = c.nd, nl = c.nl, nb = c.nb, nc = ng + nl;
  constexpr int S = 1;                   // a slot's vectors are contiguous
  float* D = slot;                       // [ng]: dispatch
  float* Sh = D + ng;                    // [nd]: shed
  float* Lp = Sh + nd;                   // [nd]: load
  float* P = Lp + nd;                    // [nl]: post flows / weights
  float* Lk = P + nl;                    // [nl]: LODF[:, k0]
  float* G = Lk + nl;                    // [nb]: bus gradient / inj
  float* parts = G + nb;                 // [2 SUM_PARTS]

  uint32_t gm[4], bm[4];
  lane_masks(gm, bm, down_in + (size_t)row * nc, ng, nl, true, r, split,
             sync_mask);
  int n_out, k0, k1;
  branch_outages(bm, 0, nl, n_out, k0, k1);
  const int mode = n_out == 1 ? 1 : 0;
  const int kc = mode ? k0 : 0;
  // The first pass's candidate, as it wrote it (an earlier launch on
  // the stream), the load and the LODF column.
  for (int j = r; j < nd; j += split) {
    Lp[j * S] = load[(size_t)row * nd + j];
    Sh[j * S] = shed_out[(size_t)row * nd + j];
  }
  for (int u = r; u < ng; u += split) D[u * S] = disp_out[(size_t)row * ng + u];
  for (int l = r; l < nl; l += split) Lk[l * S] = c.lodf[l * nl + kc];
  const float deficit = deficit_out[row];
  __syncwarp(sync_mask);
  const float served = load_total(Lp, S, nd) - deficit;
  // The bus injections (Cg disp + Cd shed) - Cd load into G.
  const auto injections = [&] {
    for (int b = r; b < nb; b += split) {
      float sg = 0.0f, sd = 0.0f, sb = 0.0f;
      for (int p = c.lists.bg_ptr[b]; p < c.lists.bg_ptr[b + 1]; ++p)
        sg += D[c.bg_idx[p] * S];
      for (int p = c.lists.bl_ptr[b]; p < c.lists.bl_ptr[b + 1]; ++p) {
        const int j = c.lists.bl_idx[p];
        sd += Sh[j * S];
        sb += Lp[j * S];
      }
      G[b * S] = (sg + sd) - sb;
    }
    __syncwarp(sync_mask);
  };
  injections();
  // The outaged branch's flow from the injections, in parts.
  const auto flow_k = [&] {
    float a[SUM_PARTS];
#pragma unroll
    for (int k = 0; k < SUM_PARTS; ++k) a[k] = 0.0f;
    for (int b0 = 0; b0 < nb; b0 += SUM_PARTS)
#pragma unroll
      for (int k = 0; k < SUM_PARTS; ++k)
        if (b0 + k < nb)
          a[k] = fmaf(G[(b0 + k) * S], c.ptdf[(b0 + k) * c.ps + kc], a[k]);
    return combine_parts(a);
  };
  float fk = flow_k();
  stream_flows<false>(c.ptdf, c.ps, nl, nb, G, S, nullptr, r, split,
                      CertTail{c.rate_ok, mode, kc, -1, mode ? fk : 0.0f,
                               0.0f, Lk, Lk, S, P, S});
  __syncwarp(sync_mask);

  const auto gcap = [&](int u) { return bit_of(gm, u) ? 0.0f : c.pmax[u]; };
  const auto lpj = [&](int j) { return Lp[j * S]; };
  for (int it = 0; it < repair_iters; ++it) {
    // Gradient weights w = sgn(post) over + brd (sgn(post) over @ LODF).
    const float2 os = group_sums(
        [&](int l) {
          const float p = P[l * S];
          const float ov = nmax(fabsf(p) - c.rate[l], 0.0f);
          return make_float2(ov, mode ? sgnf(p) * ov * Lk[l * S] : 0.0f);
        },
        nl, parts, r, split, sync_mask);
    for (int l = r; l < nl; l += split) {
      const float p = P[l * S];
      const float w = sgnf(p) * nmax(fabsf(p) - c.rate[l], 0.0f);
      P[l * S] = mode && l == kc ? w + os.y : w;
    }
    __syncwarp(sync_mask);
    // The bus gradient w @ PTDF, each bus's sum in parts; a unit's and a
    // load's gradient are its bus's (PTDF Cg, PTDF Cd: one nonzero a
    // column).
    for (int b = r; b < nb; b += split) {
      const float* row = c.ptdf + b * c.ps;   // zero past nl
      float a[SUM_PARTS];
#pragma unroll
      for (int k = 0; k < SUM_PARTS; ++k) a[k] = 0.0f;
      for (int l0 = 0; l0 < nl; l0 += SUM_PARTS) {
        const float4 p0 = *reinterpret_cast<const float4*>(row + l0);
        const float4 p1 = *reinterpret_cast<const float4*>(row + l0 + 4);
        const float pv[SUM_PARTS] = {p0.x, p0.y, p0.z, p0.w,
                                     p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int k = 0; k < SUM_PARTS; ++k)
          if (l0 + k < nl) a[k] = fmaf(P[(l0 + k) * S], pv[k], a[k]);
      }
      G[b * S] = combine_parts(a);
    }
    __syncwarp(sync_mask);
    const auto gg = [&](int u) { return G[c.gen_bus[u] * S]; };
    const float2 sg = centred_step(gg, ng, os.x, parts, r, split, sync_mask);
    rebalance_into(
        D, S, ng, served,
        [&](int u) {
          return nmin(nmax(D[u * S] - sg.y * (gg(u) - sg.x), 0.0f), gcap(u));
        },
        gcap, parts, r, split, sync_mask);
    const auto gl = [&](int j) { return G[c.load_bus[j] * S]; };
    const float2 sl = centred_step(gl, nd, deficit, parts, r, split,
                                   sync_mask);
    rebalance_into(
        Sh, S, nd, deficit,
        [&](int j) {
          return nmin(nmax(Sh[j * S] - sl.y * (gl(j) - sl.x), 0.0f), lpj(j));
        },
        lpj, parts, r, split, sync_mask);
    // The trial's injections and post-outage flows.
    injections();
    fk = flow_k();
    const bool ok = split_all(
        stream_flows<false>(c.ptdf, c.ps, nl, nb, G, S, nullptr, r, split,
                            CertTail{c.rate_ok, mode, kc, -1,
                                     mode ? fk : 0.0f, 0.0f, Lk, Lk, S, P,
                                     S}),
        split, sync_mask);
    __syncwarp(sync_mask);
    if (ok) {
      for (int j = r; j < nd; j += split)
        shed_out[(size_t)row * nd + j] = Sh[j * S];
      for (int u = r; u < ng; u += split)
        disp_out[(size_t)row * ng + u] = D[u * S];
      if (r == 0) cert[row] = 1;
      break;
    }
  }
}

// The repair: the rows the first pass listed (work[1 .. work[0]]), by
// rounds of up to REPAIR_SLOTS lanes a block over a persistent grid. A
// round of n lanes gives each the largest power of two of threads, up to
// a warp, that n groups of it fit the block (a full round: blockDim /
// 32).
__global__ void __launch_bounds__(REPAIR_THREADS)
repair_kernel(const unsigned char* __restrict__ down_in,
              const float* __restrict__ load, const float* fbuf,
              const int* ibuf, int ng, int nd, int nl, int nb,
              int repair_iters, int stage, const int* __restrict__ work,
              const float* deficit_out, unsigned char* cert_out,
              float* shed_out, float* disp_out) {
  extern __shared__ __align__(16) float smem[];
  CertNet c;
  c.ng = ng; c.nd = nd; c.nl = nl; c.nb = nb;
  const int n_q = work[0];
  // Lanes a block takes a round: the list spread evenly over the grid,
  // at most REPAIR_SLOTS (fewer lanes a block get more threads each).
  const int per = max(1, min(REPAIR_SLOTS,
                             (n_q + (int)gridDim.x - 1) / (int)gridDim.x));
  if ((int)blockIdx.x * per >= n_q) return;   // no lane for this block
  float* region = cert_stage(c, fbuf, ibuf, stage, smem);
  const int words = cert_repair_words(ng, nd, nl, nb);
  for (int base = blockIdx.x * per; base < n_q; base += gridDim.x * per) {
    const int n = min(n_q - base, per);
    int split = blockDim.x / REPAIR_SLOTS;
    while (2 * split <= 32 && 2 * split * n <= (int)blockDim.x) split *= 2;
    const int s = threadIdx.x / split, r = threadIdx.x & (split - 1);
    const unsigned group =
        split == 32 ? ~0u
                    : ((1u << split) - 1u) << ((threadIdx.x & 31) & ~(split - 1));
    // Slot s's words start at s * w, w = words rounded up to split
    // modulo 32: thread r of slot s then reads element i = r + m split
    // in bank (s split + r + m split + const) mod 32, so the round's
    // threads hit 32 different banks.
    const int w = words + ((split - words) & 31);
    __syncthreads();   // the previous round is out of the region
    if (s < n)
      repair_lane(c, region + s * w, r, split, group, work[1 + base + s],
                  down_in, load, repair_iters, deficit_out, cert_out,
                  shed_out, disp_out);
  }
}

__global__ void __launch_bounds__(CERT_MAX_THREADS)
certify_kernel(const unsigned char* __restrict__ down_in,
               const float* __restrict__ load, const float* fbuf,
               const int* ibuf, int batch, int ng, int nd, int nl, int nb,
               int repair_iters, int stage, int* __restrict__ work,
               unsigned char* cert_out, float* deficit_out, float* shed_out,
               float* disp_out) {
  extern __shared__ __align__(16) float smem[];
  CertNet c;
  c.ng = ng; c.nd = nd; c.nl = nl; c.nb = nb;
  float* region = cert_stage(c, fbuf, ibuf, stage, smem);
  const int split_log = (stage >> CERT_SPLIT_SHIFT) & 3;
  const int split = 1 << split_log;
  const int lanes = blockDim.x >> split_log, nc = ng + nl;
  const int t = threadIdx.x >> split_log, r = threadIdx.x & (split - 1);
  const int ls = cert_load_stride(nd), ds = cert_disp_stride(ng);
  float* sums = region;                        // [nb][lanes]: injections
  float* lds = sums + nb * lanes;              // [lanes][ls]: load, shed
  float* xch = lds + lanes * ls;               // states, then dispatch
  unsigned char* st = reinterpret_cast<unsigned char*>(xch);
  float* col = sums + t;

  for (int b0 = blockIdx.x * lanes; b0 < batch; b0 += gridDim.x * lanes) {
    const int rows = min(lanes, batch - b0), row = b0 + t;
    const bool live = t < rows;
    __syncthreads();   // the previous tile is out of the region

    // States and loads in, both copies in flight.
    block_copy(st, down_in + (size_t)b0 * nc, rows * nc);
    rows_copy(lds, ls, load + (size_t)b0 * nd, nd, rows, nd);
    __syncthreads();
    uint32_t gm[4], bm[4];
    lane_masks(gm, bm, st + t * nc, ng, nl, live, r, split, ~0u);
    int n_out, k0, k1;
    branch_outages(bm, 0, nl, n_out, k0, k1);
    uint32_t dbits[4];
    const float lost = unit_outages(gm, ng, c.pmax, c.list_pos, dbits);
    const float* ld = lds + t * ls;
    const Cand cand = cand_of_lane(ld, 1, nd, c.pmax_tot - lost);
    __syncthreads();   // the states are read: the dispatch takes xch

    // Dispatch into xch and injections into the column; then the shed
    // over the load row; both tiles out.
    dispatch_pass(c.lists, dbits, col, lanes, cand.load_tot - cand.deficit,
                  CertLane{ld, 1, cand, xch + t * ds, 1, c.bg_idx}, r, split,
                  ~0u);
    for (int j = r; j < nd; j += split)
      lds[t * ls + j] = cand(ld[j]);
    __syncthreads();
    rows_copy(shed_out + (size_t)b0 * nd, nd, lds, ls, rows, nd);
    rows_copy(disp_out + (size_t)b0 * ng, ng, xch, ds, rows, ng);

    // The outaged branches' flows, by the chain stream_flows runs for
    // them (so bit for bit the same); the Woodbury solve for two.
    const int mode = n_out == 1 ? 1 : (n_out == 2 ? 2 : 0);
    float a0 = 0.0f, a1 = 0.0f, sa;
    bool nonsing = true;
    if (__any_sync(0xffffffffu, mode == 1)) {
      float f;
      flow_at<false>(c.ptdf, c.ps, nb, col, lanes, nullptr,
                     mode == 1 ? k0 : 0, f, sa);
      if (mode == 1) a0 = f;
    }
    if (__any_sync(0xffffffffu, mode == 2)) {
      const int i0 = mode == 2 ? k0 : 0, i1 = mode == 2 ? k1 : 0;
      float f0, f1;
      flow_at<false>(c.ptdf, c.ps, nb, col, lanes, nullptr, i0, f0, sa);
      flow_at<false>(c.ptdf, c.ps, nb, col, lanes, nullptr, i1, f1, sa);
      if (mode == 2) {
        // dcopf._woodbury_multi_ok, k = 2, by Cramer's rule.
        const float* T = c.tr;
        const float e00 = 1.0f - T[i0 * nl + i0], e01 = 0.0f - T[i0 * nl + i1];
        const float e10 = 0.0f - T[i1 * nl + i0], e11 = 1.0f - T[i1 * nl + i1];
        const float det = e00 * e11 + (-(e01 * e10));
        nonsing = fabsf(det) > 1e-5f;
        const float safe = nonsing ? det : 1.0f;
        a0 = (f0 * e11 + (-(e01 * f1))) / safe;
        a1 = (e00 * f1 + (-(f0 * e10))) / safe;
      }
    }
    const bool checked = n_out <= 2;
    const float* col0 = (mode == 2 ? c.tr : c.lodf) + max(k0, 0);
    const float* col1 = c.tr + max(k1, 0);
    const bool clear =
        checked && stream_flows<false>(c.ptdf, c.ps, nl, nb, col, lanes,
                                       nullptr, r, split,
                                       CertTail{c.rate_ok, mode, k0, k1,
                                                a0, a1, col0, col1, nl,
                                                nullptr, 0});
    const bool ok = split_all(clear, split, ~0u) && nonsing;
    if (r == 0 && live) {
      cert_out[row] = ok;
      deficit_out[row] = cand.deficit;
    }

    // List the eligible lanes the first check failed for the repair.
    const bool need = r == 0 && live && n_out <= 1 && !ok && repair_iters > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, need);
    if (ballot) {
      const int leader = __ffs(ballot) - 1;
      const unsigned lane = threadIdx.x & 31;
      int base = 0;
      if ((int)lane == leader) base = atomicAdd(work, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (need)
        work[1 + base + __popc(ballot & ((1u << lane) - 1u))] = row;
    }
  }
}

// Allow both kernels the device's whole opt-in shared memory, once per
// process and device.
inline cudaError_t cert_prepare(int dev) {
  static uint64_t ready = 0;
  if (dev < 64 && (ready >> dev & 1)) return cudaSuccess;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(certify_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(certify_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(repair_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(repair_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 64) ready |= 1ull << dev;
  return e;
}

// Persistent blocks of `kernel`: as many as the card holds at this size,
// never more than `need`.
template <typename K>
inline cudaError_t cert_grid(K kernel, int threads, int smem, int need,
                             int dev, int* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, (size_t)smem);
  const int fill = (per_sm > 0 ? per_sm : 1) * sms;
  *grid = need < fill ? need : fill;
  return e;
}

}  // namespace psra

// C interface (bound with ctypes). down: bool [batch, ng + nl]; load:
// float32 [batch, nd]; fbuf / ibuf: the network buffers of
// cert_common.cuh (net_unpack) with one extra float, the units' total
// capacity. stage: STAGE_PTDF (required) | STAGE_LODF | STAGE_TRANSFER
// (those matrices in shared memory, else read through the cache) | log2
// of the threads a lane << CERT_SPLIT_SHIFT | (lanes a block / 32 - 1)
// << CERT_LANES_SHIFT, with lanes x threads a lane <= CERT_MAX_THREADS;
// smem_bytes must be cert_smem_bytes of that plan
// (ops/certify_kernel.py::launch_shape chooses it; anything else returns
// cudaErrorInvalidValue). work: int32 [batch + 1], the repair's list (its
// count, then rows), overwritten. Outputs: cert bool [batch], deficit
// [batch], shed [batch, nd], dispatch [batch, ng]. Launches the first
// pass and, with repair_iters > 0, the repair (its grid sized for every
// lane listed; it reads the count on the device) on `stream`, allocates
// nothing, returns the first CUDA error.
extern "C" int psra_certify(const unsigned char* down, const float* load,
                            const float* fbuf, const int* ibuf, int batch,
                            int ng, int nd, int nl, int nb, int repair_iters,
                            int stage, int smem_bytes, int* work,
                            unsigned char* cert, float* deficit, float* shed,
                            float* dispatch, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  const int lanes = (((stage >> psra::CERT_LANES_SHIFT) & 3) + 1) * 32;
  const int threads = lanes << ((stage >> psra::CERT_SPLIT_SHIFT) & 3);
  if (!(stage & psra::STAGE_PTDF) || threads > psra::CERT_MAX_THREADS ||
      smem_bytes != psra::cert_smem_bytes(ng, nd, nl, nb, stage))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rsmem = psra::cert_repair_smem_bytes(ng, nd, nl, nb, stage);
  int dev = 0, grid = 0, rgrid = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = psra::cert_prepare(dev);
  if (e == cudaSuccess)
    e = psra::cert_grid(psra::certify_kernel, threads, smem_bytes,
                        (batch + lanes - 1) / lanes, dev, &grid);
  if (e == cudaSuccess)   // a short list spreads over every block
    e = psra::cert_grid(psra::repair_kernel, psra::REPAIR_THREADS, rsmem,
                        batch, dev, &rgrid);
  if (e == cudaSuccess) e = cudaMemsetAsync(work, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  psra::certify_kernel<<<grid, threads, smem_bytes, st>>>(
      down, load, fbuf, ibuf, batch, ng, nd, nl, nb, repair_iters, stage,
      work, cert, deficit, shed, dispatch);
  if (repair_iters > 0 && (e = cudaGetLastError()) == cudaSuccess)
    psra::repair_kernel<<<rgrid, psra::REPAIR_THREADS, rsmem, st>>>(
        down, load, fbuf, ibuf, ng, nd, nl, nb, repair_iters, stage, work,
        deficit, cert, shed, dispatch);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
