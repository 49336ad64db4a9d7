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
// What bounds it on an H100: operations, ~16 kFLOP per RTS-24 lane
// (0.06 ms at B = 262144 and 67 TFLOP/s) against ~150 bytes per lane
// (0.012 ms): the flows and their error bound are two [nb] x [nb, nl]
// products.
//
// What the design does about it (cert_common.cuh): one warp per lane;
// the states never leave the warp before they are certified (one
// Philox call per thread fills the lane's component bytes in shared
// memory); lanes with two or more branch outages skip the flow check
// (the quick pass cannot certify them); the rank-1 LODF update touches
// the one outaged column. PTDF (transposed) and LODF live in shared
// memory (RTS-24: 9.4 KB).

#include "cert_common.cuh"
#include "philox.cuh"

namespace psra {

// Extras after the network floats: load [nd], hint [nd], bus load [nb],
// then (load total, capacity total).
struct QuickRows {
  const float *load, *hint, *load_bus;
  float load_tot, pmax_tot;
};

__device__ void quick_lane(const Net& net, const Scratch& w,
                           unsigned char* dn, const QuickRows& q, int row,
                           const int* seeds, const int* thresh,
                           const unsigned char* down_in, float eps,
                           unsigned char* down_out, unsigned char* ok_out,
                           float* def_out, float* shed_out) {
  const int lane = threadIdx.x & 31;
  const int ng = net.ng, nd = net.nd, nl = net.nl, nb = net.nb;
  const int nc = ng + nl;

  // The lane's states, into shared bytes dn[nc] and down_out.
  __syncwarp();   // the previous lane's readers of dn are done
  if (down_in) {
    for (int i = lane; i < nc; i += 32) dn[i] = down_in[i];
  } else if (lane < (nc + 3) / 4) {
    unsigned char fail[4];
    bernoulli4(seeds, thresh, nc, (uint32_t)row, (uint32_t)lane, fail);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * lane + k < nc) dn[4 * lane + k] = fail[k];
  }
  __syncwarp();
  for (int i = lane; i < nc; i += 32) down_out[i] = dn[i];

  // Exact copper deficit and the hint-shaped candidate at that bound:
  // clip to the loads, then move the clipped residual into the
  // remaining headroom (the up-branch of dcopf._rebalance_shed).
  LaneVec gcap = {0, 0, 0, 0}, t = {0, 0, 0, 0};
  CERT_FOR(ng) {
    const float gd = dn[j] ? 1.0f : 0.0f;
    t[r] = gd * net.pmax[j];
    gcap[r] = net.pmax[j] * (1.0f - gd);
  }
  const float cap = q.pmax_tot - vsum(t, ng);
  const float deficit = nmax(q.load_tot - cap, 0.0f);
  LaneVec ld = {0, 0, 0, 0}, cand = {0, 0, 0, 0};
  CERT_FOR(nd) {
    ld[r] = q.load[j];
    cand[r] = nmin(q.hint[j] * deficit, ld[r]);
  }
  const float tot0 = vsum(cand, nd);
  CERT_FOR(nd) t[r] = ld[r] - cand[r];
  const float head_lt = nmax(vsum(t, nd), 1e-9f);
  const float f = (deficit - tot0) / head_lt;
  CERT_FOR(nd) cand[r] = nmin(cand[r] + t[r] * f, ld[r]);
  const float served = q.load_tot - deficit;
  LaneVec disp = {0, 0, 0, 0};
  dispatch_candidate(disp, net, w, gcap, ld, cand, served);
  const Outages o = outages_of(dn + ng, nl);

  bool ok1 = false;
  if (o.n_out <= 1) {
    // Injections, and a bound on their magnitudes: every term of a bus
    // sum is nonnegative, so a = Cg disp + Cd cand + load_bus >= |inj|
    // bounds the rounding of the sums and of the flows built from them.
    vstore(w.g, disp, ng);
    vstore(w.d, cand, nd);
    LaneVec s = {0, 0, 0, 0}, inj = {0, 0, 0, 0}, a = {0, 0, 0, 0};
    bus_sums(s, net, w.g, w.d);
    CERT_FOR(nb) {
      inj[r] = s[r] - q.load_bus[j];
      a[r] = s[r] + q.load_bus[j];
    }
    vstore(w.b, inj, nb);
    vstore(w.b2, a, nb);
    LaneVec flows = {0, 0, 0, 0}, bnd = {0, 0, 0, 0};
    CERT_FOR(nl) {
      float fl = 0.0f, sa = 0.0f;
      for (int b = 0; b < nb; ++b) {
        const float p = net.ptdfT[b * nl + j];
        fl = fmaf(w.b[b], p, fl);
        sa = fmaf(w.b2[b], fabsf(p), sa);
      }
      flows[r] = fl;
      bnd[r] = eps * (sa + fabsf(fl));
    }
    // Post-outage flows and their bound: the outaged branch's own bound
    // propagates through |LODF[:, k]|.
    LaneVec post = {0, 0, 0, 0};
    if (o.n_out == 1) {
      vstore(w.l, flows, nl);
      vstore(w.l2, bnd, nl);
      const float fk = w.l[o.k0], bk = w.l2[o.k0];
      CERT_FOR(nl) {
        const float lk = net.lodf[j * nl + o.k0];
        post[r] = (flows[r] + fk * lk) * (1.0f - brd_of(o, r));
        bnd[r] = bnd[r] + bk * fabsf(lk);
      }
    } else {
      CERT_FOR(nl) post[r] = flows[r];
    }
    bool clear = true;
    CERT_FOR(nl) clear = clear && !(fabsf(post[r]) > net.rate_ok[j] - bnd[r]);
    ok1 = __all_sync(0xffffffffu, clear);
  }
  CERT_FOR(nd) shed_out[j] = cand[r];
  if (lane == 0) {
    *ok_out = ok1;
    *def_out = deficit;
  }
}

__global__ void __launch_bounds__(CERT_WARPS * 32)
quick_kernel(const int* __restrict__ seeds, const int* __restrict__ thresh,
             const unsigned char* __restrict__ down_in, const float* fbuf,
             const int* ibuf, int batch, int ng, int nd, int nl, int nb,
             int stage, float eps, unsigned char* down_out,
             unsigned char* ok1, float* deficit, float* shed) {
  extern __shared__ float smem[];
  Net net = net_unpack(fbuf, ibuf, ng, nd, nl, nb);
  const float* x = fbuf + net_floats(ng, nl, nb);
  const QuickRows q = {x, x + nd, x + 2 * nd, x[2 * nd + nb],
                       x[2 * nd + nb + 1]};
  float* rest = net_stage(net, smem, stage);
  const int nc = ng + nl;
  const int per_warp = cert_scratch(ng, nd, nl, nb) + (nc + 3) / 4;
  const int warp = threadIdx.x >> 5;
  float* mine = rest + warp * per_warp;
  const Scratch w = scratch_at(mine, net);
  unsigned char* dn =
      reinterpret_cast<unsigned char*>(mine + cert_scratch(ng, nd, nl, nb));
  for (int b = blockIdx.x * CERT_WARPS + warp; b < batch;
       b += gridDim.x * CERT_WARPS)
    quick_lane(net, w, dn, q, b, seeds, thresh,
               down_in ? down_in + (size_t)b * nc : nullptr, eps,
               down_out + (size_t)b * nc, ok1 + b, deficit + b,
               shed + (size_t)b * nd);
}

}  // namespace psra

// C interface (bound with ctypes). Random-state mode: seeds int32 [2]
// and thresh int32 [ng + nl] on the device, down_in null. Explicit mode:
// down_in bool [batch, ng + nl], seeds and thresh null. fbuf / ibuf:
// the network buffers of cert_common.cuh followed by QuickRows' floats;
// stage: STAGE_* bits chosen by the wrapper to fit `smem_bytes`; eps:
// the guard band's relative constant. Outputs: down_out bool [batch,
// ng + nl], ok1 bool [batch], deficit [batch], shed [batch, nd].
// Launches on `stream`, allocates nothing, returns the first CUDA error.
extern "C" int psra_fused_sampler_cert(
    const int* seeds, const int* thresh, const unsigned char* down_in,
    const float* fbuf, const int* ibuf, int batch, int ng, int nd, int nl,
    int nb, int stage, int smem_bytes, float eps, unsigned char* down_out,
    unsigned char* ok1, float* deficit, float* shed, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  int grid = 0;
  cudaError_t e = psra::cert_grid(psra::quick_kernel, batch,
                                  (size_t)smem_bytes, &grid);
  if (e != cudaSuccess) return (int)e;
  psra::quick_kernel<<<grid, psra::CERT_WARPS * 32, smem_bytes,
                       (cudaStream_t)stream>>>(
      seeds, thresh, down_in, fbuf, ibuf, batch, ng, nd, nl, nb, stage, eps,
      down_out, ok1, deficit, shed);
  return (int)cudaGetLastError();
}
