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
// What bounds it on an H100: operations. ~62 kFLOP per RTS-24 lane when
// every lane runs the three repair steps (flows and the repair
// gradient are [nb] x [nb, nl] products), ~0.24 ms at B = 262144 and
// 67 TFLOP/s, against ~0.03 ms of bytes.
//
// What the design does about it (cert_common.cuh): one warp per lane;
// the work a lane's data does not need is skipped without changing a
// result — the repair runs only on eligible lanes the first check
// failed, and stops at the first step that passes (later steps cannot
// change the certificate's output); the rank-1 LODF product touches the
// one outaged column, the Woodbury update the two. Matrices are kept
// once and indexed either way (LODF' and transfer' are never built):
// PTDF transposed and LODF in shared memory first, the transfer matrix
// (read only by double-outage lanes) last; what does not fit
// (RTS-96: nl = 119, 57 KB per square matrix) is read through L2.

#include "cert_common.cuh"

namespace psra {

__device__ void certify_lane(const Net& net, const Scratch& w,
                             const unsigned char* cd, const float* load_in,
                             int repair_iters, unsigned char* cert_out,
                             float* def_out, float* shed_out,
                             float* disp_out) {
  const int lane = threadIdx.x & 31;
  const int ng = net.ng, nd = net.nd, nl = net.nl, nb = net.nb;

  // Copper deficit, load-proportional candidate, dispatch.
  LaneVec gen_up = {0, 0, 0, 0}, gcap = {0, 0, 0, 0}, lp = {0, 0, 0, 0};
  LaneVec t = {0, 0, 0, 0};
  CERT_FOR(ng) {
    gen_up[r] = cd[j] ? 0.0f : 1.0f;
    t[r] = gen_up[r] * net.pmax[j];
    gcap[r] = net.pmax[j] * gen_up[r];
  }
  const float cap = vsum(t, ng);
  CERT_FOR(nd) lp[r] = load_in[j];
  const float load_tot = vsum(lp, nd);
  const float deficit = nmax(load_tot - cap, 0.0f);
  const float served = load_tot - deficit;
  LaneVec cand = {0, 0, 0, 0}, disp = {0, 0, 0, 0};
  const float frac = deficit / nmax(load_tot, 1e-9f);
  CERT_FOR(nd) cand[r] = nmin(lp[r] * frac, lp[r]);
  rebalance(cand, lp, deficit, nd);
  dispatch_candidate(disp, net, w, gcap, lp, cand, served);

  LaneVec load_bus = {0, 0, 0, 0};
  vstore(w.d, lp, nd);
  bus_sums(load_bus, net, nullptr, w.d);
  LaneVec flows = {0, 0, 0, 0};
  flows_of(flows, net, w, disp, cand, load_bus);
  const Outages o = outages_of(cd + ng, nl);

  // The candidate is the output unless a repair step passes.
  CERT_FOR(nd) shed_out[j] = cand[r];
  CERT_FOR(ng) disp_out[j] = disp[r];

  bool certified = false;
  if (o.n_out <= 1) {
    LaneVec post = {0, 0, 0, 0};
    post_flows(post, net, w, flows, o);
    certified = flows_ok(post, net);
    // Repair descent (dcopf._repair_descent): move shed and dispatch
    // along their PTDF sensitivities, rebalance, re-check.
    for (int it = 0; it < repair_iters && !certified; ++it) {
      LaneVec over = {0, 0, 0, 0}, wv = {0, 0, 0, 0};
      CERT_FOR(nl) {
        over[r] = nmax(fabsf(post[r]) - net.rate[j], 0.0f);
        wv[r] = sgnf(post[r]) * over[r];
      }
      const float sum_over = vsum(over, nl);
      if (o.n_out == 1) {   // w = sgn_over + brd (sgn_over @ LODF)
        LaneVec p = {0, 0, 0, 0};
        CERT_FOR(nl) p[r] = wv[r] * net.lodf[j * nl + o.k0];
        const float s = vsum(p, nl);
        CERT_FOR(nl) if (j == o.k0) wv[r] = wv[r] + s;
      }
      vstore(w.l, wv, nl);
      // g_bus = w @ PTDF per bus; the unit and load gradients are its
      // gathers (PTDF Cg and PTDF Cd have one nonzero per column).
      LaneVec gb = {0, 0, 0, 0};
      CERT_FOR(nb) {
        float s = 0.0f;
        for (int l = 0; l < nl; ++l) s = fmaf(w.l[l], net.ptdfT[j * nl + l], s);
        gb[r] = s;
      }
      vstore(w.b, gb, nb);
      LaneVec grad = {0, 0, 0, 0};
      CERT_FOR(ng) grad[r] = w.b[net.gen_bus[j]];
      float mean = vsum(grad, ng) / ng;
      CERT_FOR(ng) grad[r] = grad[r] - mean;
      const float step_g = sum_over / nmax(vmaxabs(grad, ng), 1e-9f);
      LaneVec disp_t = {0, 0, 0, 0};
      CERT_FOR(ng)
        disp_t[r] = nmin(nmax(disp[r] - step_g * grad[r], 0.0f), gcap[r]);
      rebalance(disp_t, gcap, served, ng);
      CERT_FOR(nd) grad[r] = w.b[net.load_bus[j]];
      mean = vsum(grad, nd) / nd;
      CERT_FOR(nd) grad[r] = grad[r] - mean;
      const float step_sz = deficit / nmax(vmaxabs(grad, nd), 1e-9f);
      LaneVec trial = {0, 0, 0, 0};
      CERT_FOR(nd)
        trial[r] = nmin(nmax(cand[r] - step_sz * grad[r], 0.0f), lp[r]);
      rebalance(trial, lp, deficit, nd);
      LaneVec f_t = {0, 0, 0, 0};
      flows_of(f_t, net, w, disp_t, trial, load_bus);
      post_flows(post, net, w, f_t, o);
      certified = flows_ok(post, net);
      if (certified) {
        CERT_FOR(nd) shed_out[j] = trial[r];
        CERT_FOR(ng) disp_out[j] = disp_t[r];
      }
      CERT_FOR(nd) cand[r] = trial[r];
      CERT_FOR(ng) disp[r] = disp_t[r];
    }
  } else if (o.n_out == 2) {
    // Rank-2 Woodbury on the two outaged branches k0 < k1 (dcopf.
    // _woodbury_multi_ok, k = 2, Cramer's rule as _cramer_solve).
    const float* T = net.transfer;
    const int k0 = o.k0, k1 = o.k1;
    const float e00 = 1.0f - T[k0 * nl + k0], e01 = 0.0f - T[k0 * nl + k1];
    const float e10 = 0.0f - T[k1 * nl + k0], e11 = 1.0f - T[k1 * nl + k1];
    vstore(w.l, flows, nl);
    const float f0 = w.l[k0], f1 = w.l[k1];
    const float det = e00 * e11 + (-(e01 * e10));
    const bool nonsing = fabsf(det) > 1e-5f;
    const float safe = nonsing ? det : 1.0f;
    const float c0 = (f0 * e11 + (-(e01 * f1))) / safe;
    const float c1 = (e00 * f1 + (-(f0 * e10))) / safe;
    LaneVec post = {0, 0, 0, 0};
    CERT_FOR(nl)
      post[r] = (flows[r] + (c0 * T[j * nl + k0] + c1 * T[j * nl + k1]))
                * (1.0f - brd_of(o, r));
    certified = flows_ok(post, net) && nonsing;
  }
  if (lane == 0) {
    *cert_out = certified;
    *def_out = deficit;
  }
}

__global__ void __launch_bounds__(CERT_WARPS * 32)
certify_kernel(const unsigned char* __restrict__ down,
               const float* __restrict__ load, const float* fbuf,
               const int* ibuf, int batch, int ng, int nd, int nl, int nb,
               int repair_iters, int stage, unsigned char* cert,
               float* deficit, float* shed, float* dispatch) {
  extern __shared__ float smem[];
  Net net = net_unpack(fbuf, ibuf, ng, nd, nl, nb);
  float* rest = net_stage(net, smem, stage);
  const int warp = threadIdx.x >> 5;
  const Scratch w =
      scratch_at(rest + warp * cert_scratch(ng, nd, nl, nb), net);
  const int nc = ng + nl;
  for (int b = blockIdx.x * CERT_WARPS + warp; b < batch;
       b += gridDim.x * CERT_WARPS)
    certify_lane(net, w, down + (size_t)b * nc, load + (size_t)b * nd,
                 repair_iters, cert + b, deficit + b, shed + (size_t)b * nd,
                 dispatch + (size_t)b * ng);
}

}  // namespace psra

// C interface (bound with ctypes). down: bool [batch, ng + nl]; load:
// float32 [batch, nd]; fbuf / ibuf: the network buffers of
// cert_common.cuh (net_unpack); stage: which matrices go to shared
// memory (STAGE_* bits), chosen by the wrapper to fit `smem_bytes`.
// Outputs: cert bool [batch], deficit [batch], shed [batch, nd],
// dispatch [batch, ng]. Launches on `stream`, allocates nothing, returns
// the first CUDA error.
extern "C" int psra_certify(const unsigned char* down, const float* load,
                            const float* fbuf, const int* ibuf, int batch,
                            int ng, int nd, int nl, int nb, int repair_iters,
                            int stage, int smem_bytes, unsigned char* cert,
                            float* deficit, float* shed, float* dispatch,
                            void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  int grid = 0;
  cudaError_t e = psra::cert_grid(psra::certify_kernel, batch,
                                  (size_t)smem_bytes, &grid);
  if (e != cudaSuccess) return (int)e;
  psra::certify_kernel<<<grid, psra::CERT_WARPS * 32, smem_bytes,
                         (cudaStream_t)stream>>>(
      down, load, fbuf, ibuf, batch, ng, nd, nl, nb, repair_iters, stage,
      cert, deficit, shed, dispatch);
  return (int)cudaGetLastError();
}
