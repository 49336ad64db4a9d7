// Fused Mehrotra predictor-corrector loop for the structured DC-OPF LP
// (m = nb + nl <= 72 rows, n = ng + nd + nl + nb columns), float32.
//
// Replaces: the TPU Pallas kernel of
//   powersystemsreliabilityassessment_tpu/ops/ipm_fused.py —
//   fused_ipm_iterations (kernel body _make_kernel) —
//   which runs every interior-point iteration of 128 lanes in one grid
//   step with the iterate state resident in VMEM.
//
// What bounds it on an H100: per LP lane and iteration the work is one
// normal-matrix formation (~0.1 Mflop), one 62 x 62 Cholesky (~80 kflop
// over 62 dependent steps) and four triangular substitutions (4 x 62
// dependent steps). The lane's whole state is ~43 KB, so device-memory
// bytes are no bound at all; the chain of ~700 dependent block-wide
// steps per iteration (barriers and shared-memory round trips) is.
//
// What the design does about it: one thread block per LP lane holds the
// entire iterate (x, y, zl, zu, best iterate, bounds, costs, the shared
// LP structure and the normal matrix) in shared memory for all
// iterations, so device memory is read once on entry and written once
// on exit, and the loop runs in a single launch. The normal matrix is
// formed straight from the balance block A0 and the gauge-fixed
// incidence Mref, not from the TPU's pair-product matrices P_bal
// [nb^2, n] and Q_theta [nl^2, nb] (those fed the TPU's matrix unit and
// would exceed the block's shared memory). Each step of the factorization
// and the substitutions is spread over the block's 256 threads with one
// barrier per step. A lane that freezes (mu < mu_tol or a non-finite
// step) never changes again in the reference, so its block stops early:
// exactly the fixed-count loop's result, without its idle iterations.

#include "common.cuh"

namespace psra {

constexpr int IPM_THREADS = 256;

struct IPMArgs {
  // Per-lane inputs, batch-major and contiguous.
  const float* colscale;  // [B, n]
  const float* br_up;     // [B, nl]
  const float* c;         // [B, n]
  const float* b;         // [B, m]
  const float* l;         // [B, n]
  const float* u;         // [B, n]
  // Shared LP structure.
  const float* a0;    // [nb, n] balance block [Cg | Cd | -Minc' | 0]
  const float* mref;  // [nl, nb] incidence with the reference column zeroed
  const float* invb;  // [nl] branch reactances 1/b
  // Outputs, batch-major.
  float* x;           // [B, n]
  float* y;           // [B, m]
  float* zl;          // [B, n]
  float* zu;          // [B, n]
  float* best_x;      // [B, n]
  float* best_score;  // [B]
  int ng, nd, nl, nb, iters;
  float tau, delta, mu_tol, center_tol;
};

// Number of float32 words of dynamic shared memory one block uses.
__host__ __device__ inline int ipm_smem_words(int ng, int nd, int nl, int nb) {
  const int n = ng + nd + nl + nb, m = nb + nl;
  return nb * n + nl * nb + 2 * nl + m * m + 23 * n + 9 * m + 64;
}

struct Lane {
  int n, m, nb, nl, f_lo, f_hi;
  float *a0, *mref, *invb, *bru, *M, *red;
  // n-vectors
  float *cs, *cc, *lo, *up, *x, *zl, *zu, *bx, *sl, *su, *rd, *d, *rhat;
  float *dx, *dzl, *dzu, *dxa, *dzla, *dzua, *tn, *rcl, *rcu, *wb;
  // m-vectors
  float *bv, *y, *rp, *rhs, *dy, *tm, *sc, *zs, *y2;
};

__device__ Lane carve(float* s, int ng, int nd, int nl, int nb) {
  Lane L;
  L.nb = nb;
  L.nl = nl;
  L.n = ng + nd + nl + nb;
  L.m = nb + nl;
  L.f_lo = ng + nd;
  L.f_hi = ng + nd + nl;
  const int n = L.n, m = L.m;
  L.a0 = s; s += nb * n;
  L.mref = s; s += nl * nb;
  L.invb = s; s += nl;
  L.bru = s; s += nl;
  L.M = s; s += m * m;
  float** nv[] = {&L.cs, &L.cc, &L.lo, &L.up, &L.x, &L.zl, &L.zu, &L.bx,
                  &L.sl, &L.su, &L.rd, &L.d, &L.rhat, &L.dx, &L.dzl, &L.dzu,
                  &L.dxa, &L.dzla, &L.dzua, &L.tn, &L.rcl, &L.rcu, &L.wb};
  for (float** p : nv) { *p = s; s += n; }
  float** mv[] = {&L.bv, &L.y, &L.rp, &L.rhs, &L.dy, &L.tm, &L.sc, &L.zs,
                  &L.y2};
  for (float** p : mv) { *p = s; s += m; }
  L.red = s;
  return L;
}

// out = A v for the lane's A (reference mv_A): balance rows
// A0 (colscale * v); flow rows invb * v_f - bru * (Mref v_theta).
__device__ void apply_a(const Lane& L, const float* v, float* out) {
  for (int i = threadIdx.x; i < L.m; i += blockDim.x) {
    float acc = 0.0f;
    if (i < L.nb) {
      const float* row = L.a0 + i * L.n;
      for (int k = 0; k < L.n; ++k) acc += row[k] * (L.cs[k] * v[k]);
    } else {
      const int l = i - L.nb;
      const float* row = L.mref + l * L.nb;
      float t = 0.0f;
      for (int j = 0; j < L.nb; ++j) t += row[j] * v[L.f_hi + j];
      acc = L.invb[l] * v[L.f_lo + l] - L.bru[l] * t;
    }
    out[i] = acc;
  }
}

// out = A' w (reference mtv_A): colscale * (A0' w_bal), plus invb * w_f
// on the flow columns and minus Mref' (bru * w_f) on the angle columns.
__device__ void apply_at(const Lane& L, const float* w, float* out) {
  for (int k = threadIdx.x; k < L.n; k += blockDim.x) {
    float t = 0.0f;
    for (int i = 0; i < L.nb; ++i) t += L.a0[i * L.n + k] * w[i];
    float r = L.cs[k] * t;
    if (k >= L.f_lo && k < L.f_hi) {
      const int l = k - L.f_lo;
      r += L.invb[l] * w[L.nb + l];
    } else if (k >= L.f_hi) {
      const int j = k - L.f_hi;
      float q = 0.0f;
      for (int l = 0; l < L.nl; ++l)
        q += L.mref[l * L.nb + j] * (L.bru[l] * w[L.nb + l]);
      r -= q;
    }
    out[k] = r;
  }
}

// M = A diag(1/d) A', equilibrated to a unit diagonal (scale in L.sc),
// regularized by delta on the diagonal, then factored in place.
__device__ void form_and_factor(const Lane& L, float delta) {
  const int n = L.n, m = L.m, nb = L.nb;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    L.wb[k] = L.cs[k] * L.cs[k] / L.d[k];
  __syncthreads();
  for (int t = threadIdx.x; t < m * m; t += blockDim.x) {
    const int i = t / m, j = t % m;
    float v;
    if (i < nb && j < nb) {
      const float* ri = L.a0 + i * n;
      const float* rj = L.a0 + j * n;
      v = 0.0f;
      for (int k = 0; k < n; ++k) v += (ri[k] * rj[k]) * L.wb[k];
    } else if (i < nb) {
      const int l = j - nb;
      v = L.a0[i * n + L.f_lo + l] * (L.wb[L.f_lo + l] * L.invb[l]);
    } else if (j < nb) {
      const int l = i - nb;
      v = L.a0[j * n + L.f_lo + l] * (L.wb[L.f_lo + l] * L.invb[l]);
    } else {
      const int l1 = i - nb, l2 = j - nb;
      const float* r1 = L.mref + l1 * nb;
      const float* r2 = L.mref + l2 * nb;
      float q = 0.0f;
      for (int jj = 0; jj < nb; ++jj) q += (r1[jj] * r2[jj]) * L.wb[L.f_hi + jj];
      v = q * L.bru[l1] * L.bru[l2];
      if (l1 == l2) v += L.invb[l1] * (L.wb[L.f_lo + l1] * L.invb[l1]);
    }
    L.M[t] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    L.sc[i] = rsqrtf(nmax(L.M[i * m + i], 1e-30f));
  __syncthreads();
  for (int t = threadIdx.x; t < m * m; t += blockDim.x) {
    const int i = t / m, j = t % m;
    L.M[t] = L.M[t] * L.sc[i] * L.sc[j] + (i == j ? delta : 0.0f);
  }
  chol_inplace(L.M, m, m);
}

// out = (S L L' S)^-1 rhs with the factor in L.M and scale S = L.sc:
// column-oriented forward and back substitution, one barrier per step.
__device__ void solve_m(const Lane& L, const float* rhs, float* out) {
  const int m = L.m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) L.zs[i] = L.sc[i] * rhs[i];
  __syncthreads();
  for (int k = 0; k < m; ++k) {          // L y2 = zs
    const float yk = L.zs[k] / L.M[k * m + k];
    if (threadIdx.x == 0) L.y2[k] = yk;
    for (int i = k + 1 + threadIdx.x; i < m; i += blockDim.x)
      L.zs[i] -= L.M[i * m + k] * yk;
    __syncthreads();
  }
  for (int k = m - 1; k >= 0; --k) {     // L' zs = y2
    const float xk = L.y2[k] / L.M[k * m + k];
    if (threadIdx.x == 0) L.zs[k] = xk;
    for (int i = threadIdx.x; i < k; i += blockDim.x)
      L.y2[i] -= L.M[k * m + i] * xk;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) out[i] = L.sc[i] * L.zs[i];
  __syncthreads();
}

// One Newton solve of the reduced KKT system (reference `newton`).
__device__ void newton(const Lane& L, const float* rcl, const float* rcu,
                       float* dx, float* dy, float* dzl, float* dzu) {
  for (int k = threadIdx.x; k < L.n; k += blockDim.x) {
    const float rh = L.rd[k] - rcl[k] / L.sl[k] + rcu[k] / L.su[k];
    L.rhat[k] = rh;
    L.tn[k] = rh / L.d[k];
  }
  __syncthreads();
  apply_a(L, L.tn, L.tm);
  __syncthreads();
  for (int i = threadIdx.x; i < L.m; i += blockDim.x) L.rhs[i] = L.rp[i] + L.tm[i];
  __syncthreads();
  solve_m(L, L.rhs, dy);
  apply_at(L, dy, L.tn);
  __syncthreads();
  for (int k = threadIdx.x; k < L.n; k += blockDim.x) {
    const float dxk = (L.tn[k] - L.rhat[k]) / L.d[k];
    dx[k] = dxk;
    dzl[k] = (rcl[k] - L.zl[k] * dxk) / L.sl[k];
    dzu[k] = (rcu[k] + L.zu[k] * dxk) / L.su[k];
  }
  __syncthreads();
}

// Fraction-to-boundary step lengths (reference `max_step`).
__device__ void max_step(const Lane& L, const float* dx, const float* dzl,
                         const float* dzu, float tau, float* ap, float* ad) {
  const float big = 1e30f;
  float pa = big, da = big;
  for (int k = threadIdx.x; k < L.n; k += blockDim.x) {
    const float v = dx[k];
    const float t1 = v < 0.0f ? -L.sl[k] / fminf(v, -1e-30f) : big;
    const float t2 = v > 0.0f ? L.su[k] / fmaxf(v, 1e-30f) : big;
    pa = fminf(pa, fminf(t1, t2));
    const float e1 = dzl[k] < 0.0f ? -L.zl[k] / fminf(dzl[k], -1e-30f) : big;
    const float e2 = dzu[k] < 0.0f ? -L.zu[k] / fminf(dzu[k], -1e-30f) : big;
    da = fminf(da, fminf(e1, e2));
  }
  pa = block_reduce<kMin>(pa, L.red);
  da = block_reduce<kMin>(da, L.red);
  *ap = fminf(tau * pa, 1.0f);
  *ad = fminf(tau * da, 1.0f);
}

__global__ void __launch_bounds__(IPM_THREADS) fused_ipm_kernel(IPMArgs p) {
  extern __shared__ float smem[];
  const Lane L = carve(smem, p.ng, p.nd, p.nl, p.nb);
  const int n = L.n, m = L.m, nb = L.nb, nl = L.nl;
  const size_t ln = (size_t)blockIdx.x * n, lm = (size_t)blockIdx.x * m;
  const size_t ll = (size_t)blockIdx.x * nl;
  const float inv2n = 1.0f / (2.0f * n);

  for (int t = threadIdx.x; t < nb * n; t += blockDim.x) L.a0[t] = p.a0[t];
  for (int t = threadIdx.x; t < nl * nb; t += blockDim.x) L.mref[t] = p.mref[t];
  for (int t = threadIdx.x; t < nl; t += blockDim.x) {
    L.invb[t] = p.invb[t];
    L.bru[t] = p.br_up[ll + t];
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    L.cs[k] = p.colscale[ln + k];
    L.cc[k] = p.c[ln + k];
    L.lo[k] = p.l[ln + k];
    L.up[k] = p.u[ln + k];
    const float x0 = 0.5f * (L.lo[k] + L.up[k]);
    L.x[k] = x0;
    L.bx[k] = x0;
    L.zl[k] = 1.0f;
    L.zu[k] = 1.0f;
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    L.bv[i] = p.b[lm + i];
    L.y[i] = 0.0f;
  }
  __syncthreads();

  float best = INFINITY;
  for (int it = 0; it < p.iters; ++it) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      L.sl[k] = nmax(L.x[k] - L.lo[k], 1e-12f);
      L.su[k] = nmax(L.up[k] - L.x[k], 1e-12f);
    }
    __syncthreads();
    apply_a(L, L.x, L.tm);
    apply_at(L, L.y, L.tn);
    __syncthreads();
    float loc_rp = 0.0f, loc_mu = 0.0f;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      L.rp[i] = L.bv[i] - L.tm[i];
      loc_rp = fmaxf(loc_rp, fabsf(L.rp[i]));
    }
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      L.rd[k] = L.cc[k] - L.tn[k] - L.zl[k] + L.zu[k];
      loc_mu += L.sl[k] * L.zl[k] + L.su[k] * L.zu[k];
    }
    const float mu = block_reduce<kSum>(loc_mu, L.red) * inv2n;
    const float score = mu + block_reduce<kMax>(loc_rp, L.red);
    if (score < best) {  // block-uniform
      best = score;
      for (int k = threadIdx.x; k < n; k += blockDim.x) L.bx[k] = L.x[k];
    }
    if (mu < p.mu_tol) break;  // frozen: the state never changes again

    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      L.d[k] = nclip(L.zl[k] / L.sl[k] + L.zu[k] / L.su[k], 1e-6f, 1e10f);
      L.rcl[k] = -L.sl[k] * L.zl[k];
      L.rcu[k] = -L.su[k] * L.zu[k];
    }
    __syncthreads();
    form_and_factor(L, p.delta);
    const bool centering = mu < p.center_tol;

    // Predictor (affine) step; computed even when centering, as the
    // reference does, so a non-finite affine direction still freezes
    // the lane through gate * dxa.
    newton(L, L.rcl, L.rcu, L.dxa, L.dy, L.dzla, L.dzua);
    float apa, ada;
    max_step(L, L.dxa, L.dzla, L.dzua, p.tau, &apa, &ada);
    float loc = 0.0f;
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      loc += (L.sl[k] + apa * L.dxa[k]) * (L.zl[k] + ada * L.dzla[k])
             + (L.su[k] - apa * L.dxa[k]) * (L.zu[k] + ada * L.dzua[k]);
    const float mu_aff = block_reduce<kSum>(loc, L.red) * inv2n;
    const float ratio = mu_aff / nmax(mu, 1e-12f);
    const float sigma = centering ? 0.5f : nclip(ratio * ratio * ratio, 0.0f, 1.0f);
    const float gate = centering ? 0.0f : 1.0f;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      L.rcl[k] = sigma * mu - L.sl[k] * L.zl[k] - gate * L.dxa[k] * L.dzla[k];
      L.rcu[k] = sigma * mu - L.su[k] * L.zu[k] + gate * L.dxa[k] * L.dzua[k];
    }
    __syncthreads();

    // Corrector step.
    newton(L, L.rcl, L.rcu, L.dx, L.dy, L.dzl, L.dzu);
    float ap, ad;
    max_step(L, L.dx, L.dzl, L.dzu, p.tau, &ap, &ad);
    const float damp = centering ? 0.9f : 1.0f;
    ap *= damp;
    ad *= damp;

    // Candidate iterate into the (now free) affine buffers and rhs.
    float fin = 1.0f;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const float margin = 1e-9f * nmax(L.up[k] - L.lo[k], 1e-12f);
      const float xn = nclip(L.x[k] + ap * L.dx[k], L.lo[k] + margin,
                             L.up[k] - margin);
      const float zln = nmax(L.zl[k] + ad * L.dzl[k], 1e-12f);
      const float zun = nmax(L.zu[k] + ad * L.dzu[k], 1e-12f);
      L.dxa[k] = xn;
      L.dzla[k] = zln;
      L.dzua[k] = zun;
      if (!(isfinite(xn) && isfinite(zln) && isfinite(zun))) fin = 0.0f;
    }
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const float yn = L.y[i] + ad * L.dy[i];
      L.rhs[i] = yn;
      if (!isfinite(yn)) fin = 0.0f;
    }
    if (block_reduce<kMin>(fin, L.red) < 0.5f) break;  // frozen, state kept
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      L.x[k] = L.dxa[k];
      L.zl[k] = L.dzla[k];
      L.zu[k] = L.dzua[k];
    }
    for (int i = threadIdx.x; i < m; i += blockDim.x) L.y[i] = L.rhs[i];
    __syncthreads();
  }

  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    p.x[ln + k] = L.x[k];
    p.zl[ln + k] = L.zl[k];
    p.zu[ln + k] = L.zu[k];
    p.best_x[ln + k] = L.bx[k];
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) p.y[lm + i] = L.y[i];
  if (threadIdx.x == 0) p.best_score[blockIdx.x] = best;
}

}  // namespace psra

// C interface (bound with ctypes): launches one block per LP lane on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int psra_fused_ipm(
    const float* colscale, const float* br_up, const float* c,
    const float* b, const float* l, const float* u,
    const float* a0, const float* mref, const float* invb,
    float* x, float* y, float* zl, float* zu, float* best_x,
    float* best_score, int batch, int ng, int nd, int nl, int nb,
    int iters, float tau, float delta, float mu_tol, float center_tol,
    void* stream) {
  psra::IPMArgs p{colscale, br_up, c, b, l, u, a0, mref, invb,
                  x, y, zl, zu, best_x, best_score,
                  ng, nd, nl, nb, iters, tau, delta, mu_tol, center_tol};
  const int bytes = psra::ipm_smem_words(ng, nd, nl, nb) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      psra::fused_ipm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0)
    psra::fused_ipm_kernel<<<batch, psra::IPM_THREADS, bytes,
                             (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
