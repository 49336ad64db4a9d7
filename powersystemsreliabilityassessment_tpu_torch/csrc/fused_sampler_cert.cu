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
// - Flows: streamed over chunks of FLOW_CHUNK branches whose flows and
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
// The mask, sums and flow pieces are shared with K5 (lane_common.cuh).

#include <stdint.h>

#include "cert_common.cuh"
#include "lane_common.cuh"
#include "philox.cuh"

namespace psra {

constexpr int QUICK_MAX_LANES = 128;     // state lanes a block
constexpr int QUICK_MAX_THREADS = 256;   // lanes x threads a lane
// Bits 8-9 of `stage`: log2 of the threads a lane (1, 2, 4 or 8).
constexpr int QUICK_SPLIT_SHIFT = 8;

// The shared-memory plan, mirrored by ops/fused_sampler_cert.py.

// Words of the broadcast vectors: thresholds [nc], pmax [ng] in unit
// order and [ng] in list order, each unit's position in the unit lists
// [ng], load and hint [nd], bus load [nb], rate + 1e-4 [nl], and the
// list pointers and load indices (bg_ptr [nb + 1], bl_ptr [nb + 1],
// bl_idx [nd]).
__host__ __device__ __forceinline__ int quick_small_words(int ng, int nd,
                                                          int nl, int nb) {
  return round4((ng + nl) + 3 * ng + 3 * nd + 3 * nb + nl + 2);
}

// Words before the lanes' region: the vectors, PTDF (always: <= 64 KB
// for dimensions <= 128), then LODF where `stage` flags it.
__host__ __device__ __forceinline__ int quick_staged_words(int ng, int nd,
                                                           int nl, int nb,
                                                           int stage) {
  return quick_small_words(ng, nd, nl, nb) + nb * flow_ptdf_stride(nl) +
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
  const int* list_pos;                // [ng]: unit u is at list_pos[u]
  const float *load, *hint, *load_bus, *rate_ok;
  BusLists lists;                     // per-bus units and loads
  const float* ptdf;                  // [nb][ptdf_stride]: PTDF[l, b]
  int ptdf_stride;                    // nl rounded up to FLOW_CHUNK
  const float* lodf;                  // [nl][nl]
  float load_tot, pmax_tot;
};

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
  q.lists.pmax_at = pmax_at;
  q.list_pos = list_pos;
  cur += 2 * ng;
  q.load = stage_into(cur, x, nd);
  q.hint = stage_into(cur, x + nd, nd);
  q.load_bus = stage_into(cur, x + 2 * nd, nb);
  q.rate_ok = stage_into(cur, net.rate_ok, nl);
  q.lists.nb = nb;
  q.lists.bg_ptr = stage_into(cur, net.bg_ptr, nb + 1);
  q.lists.bl_ptr = stage_into(cur, net.bl_ptr, nb + 1);
  q.lists.bl_idx = stage_into(cur, net.bl_idx, nd);
  cur = smem + quick_small_words(ng, nd, nl, nb);
  stage_ptdf(cur, net.ptdfT, nl, nb);
  q.ptdf = cur;
  q.ptdf_stride = flow_ptdf_stride(nl);
  cur += nb * q.ptdf_stride;
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
  cp_async_wait_block();
  return cur;
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

// The hint-shaped candidate at the deficit, load j: clip to the load,
// then move the clipped residual into the remaining headroom by the
// lane's factor fc (the up-branch of dcopf._rebalance_shed).
__device__ __forceinline__ float cand_of(const QuickNet& q, int j,
                                         float deficit, float fc) {
  const float ld = q.load[j];
  const float c0 = nmin(q.hint[j] * deficit, ld);
  return nmin(fmaf(ld - c0, fc, c0), ld);
}

// K4's lane for dispatch_pass: the batch-constant load, the hint-shaped
// candidate, no per-unit output; the column keeps Cg disp + Cd shed.
struct QuickLane {
  static constexpr bool kInj = false, kParts = false;
  const QuickNet& q;
  float deficit, fc;
  __device__ __forceinline__ float load(int l) const { return q.load[l]; }
  __device__ __forceinline__ float cand(int l) const {
    return cand_of(q, l, deficit, fc);
  }
  __device__ __forceinline__ void unit(int, float) const {}
};

// The banded post-outage check of one branch: p_l = (f_l + fk LODF[l,
// k]) (1 - [l == k]) against rate_l + 1e-4 - (eps (S_l + |f_l|) + bk
// |LODF[l, k]|). k < 0: no outaged branch.
struct QuickTail {
  const QuickNet& q;
  int k;
  float fk, bk, eps;
  __device__ __forceinline__ bool operator()(int l, float fl,
                                             float sa) const {
    const float lk = k >= 0 ? q.lodf[l * q.nl + k] : 0.0f;
    const float post = fmaf(fk, lk, fl) * (l == k ? 0.0f : 1.0f);
    const float bnd = fmaf(bk, fabsf(lk), eps * (sa + fabsf(fl)));
    return !(fabsf(post) > q.rate_ok[l] - bnd);
  }
};

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
    join_mask(m, split, ~0u);
    block_copy(down_out + (size_t)b0 * nc, io, rows * nc);
    int n_out, k, k1;
    branch_outages(m, ng, nc, n_out, k, k1);

    // Exact copper deficit (sum of the lost capacities in unit order),
    // the units' outage bits in list order, and the candidate's factor.
    uint32_t down[4];
    const float lost = unit_outages(m, ng, q.pmax, q.list_pos, down);
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

    dispatch_pass(q.lists, down, col, lanes, q.load_tot - deficit,
                  QuickLane{q, deficit, fc}, r, split, ~0u);

    // The outaged branch's flow and bound, by the chain stream_flows
    // runs for it (so bit for bit the same), then the banded check.
    const bool single = n_out == 1;
    float fk = 0.0f, bk = 0.0f;
    if (__any_sync(0xffffffffu, single)) {
      float f, sa;
      flow_at<true>(q.ptdf, q.ptdf_stride, nb, col, lanes, q.load_bus,
                    single ? k : 0, f, sa);
      if (single) {
        fk = f;
        bk = eps * (sa + fabsf(f));
      }
    }
    const bool clear = split_all(
        stream_flows<true>(q.ptdf, q.ptdf_stride, nl, nb, col, lanes,
                           q.load_bus, r, split,
                           QuickTail{q, single ? k : -1, fk, bk, eps}),
        split, ~0u);
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
