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
// normal-matrix formation, one m x m Cholesky (m^3 / 3 ~ 80 kflop at
// m = 62, over m dependent pivots) and four triangular substitutions
// (4 x m dependent steps). A lane's state is ~12 KB, read and written
// once, so neither bytes nor flops bound it: the latency of each lane's
// chain of dependent steps does, and at 2,048 lanes also the issue rate
// of the SMs' schedulers. The first port of this kernel ran a lane on
// a 256-thread block with ~420 block-wide barriers an iteration: 2.40 ms
// for 256 lanes and 14.87 ms for 2,048 (scripts/torch_k1_bench.py
// --source, NVIDIA H100 80GB HBM3, 700.00 W).
//
// What the design does about it:
// - A lane is a group of one or two warps (WPL): one warp at 2,048 lanes
//   (16 lanes a SM, all resident), two at 256 lanes, where the card has
//   schedulers to spare and the row and column work of each thread
//   halves; ops/ipm_fused.py::launch_shape picks. Lanes freeze at
//   different iterations, so after the structure is staged the loop never
//   meets the block: __syncwarp or the lane's named barrier (bar.sync id,
//   64), reductions by shuffle. Several lanes share a block and its
//   staged structure; the shared-memory opt-in is set once per process.
// - Rows are striped over the lane's threads (row i on thread
//   i mod 32 WPL; right-hand sides, scalings and 1 / L_ii in registers).
//   M keeps only its lower triangle, packed (row i at i (i + 1) / 2): 32
//   consecutive rows start on 32 distinct banks, so a column read across
//   the warp is conflict-free. The factor is right-looking, blocked by 4
//   pivots: every thread factors a panel's 4 x 4 diagonal block itself
//   (no broadcast chain), its rows' panel entries in registers, then the
//   columns right of the panel take 4 updates for one load and one store
//   an entry, with column k broadcast by shuffle (M being symmetric,
//   L[j][k] stands in for the upper triangle's read). Each entry still
//   takes its updates in pivot order, so the factor is the unblocked
//   one's bit for bit. The substitutions are shuffle chains that multiply
//   by 1 / L_kk, taken once per factor (rsqrt of the pivot unless it was
//   floored, where it keeps the plain version's divisor).
// - Latency is what a lane waits on, so the code keeps loads off the
//   chains: loads are unconditional from addresses clamped inside M (a
//   predicated load serializes on its temporary register) and only
//   stores and selects are predicated; every load of an update round is
//   issued before its stores (the compiler cannot tell rows apart); and
//   per-row or per-column bodies and the two Newton solves run in loops
//   that are not unrolled, so the hot loops stay in the instruction
//   cache.
// - The normal matrix and the A-products come from the incidence lists
//   (each generator's and load's bus, each branch's ends, each bus's
//   columns of A0 = [Cg | Cd | -Minc' | 0]), not from dense A0 and Mref:
//   every column of A0 has at most two nonzeros and every row of Mref at
//   most two. Each entry of M has one owner (its row's thread) and one
//   summation order, the dense order without its zero terms.
// - Float32 throughout, no tensor cores: K1_OBJ_BOUND (chip_smoke.py)
//   assumes float32 arithmetic, and the work has no matrix product.

#include <stdint.h>

#include "common.cuh"

namespace psra {

constexpr int IPM_MAX_LPB = 4;      // LP lanes per block at most
constexpr int IPM_MAX_WPL = 2;      // warps a lane at most
constexpr int IPM_KB = 4;           // pivots a panel of the factor
constexpr int IPM_JC = 4;           // columns a round of the trailing update

__host__ __device__ constexpr int ipm_tri(int i) { return i * (i + 1) / 2; }

// Float32 words of one lane's shared memory: the packed lower triangle
// of M, six n-vectors (colscale, c, l, u, best x, a gather scratch), two
// m-vectors (a gather scratch, the equilibration scale), br_up and a
// scaled flow scratch, two reduction slots of a word a warp and two
// broadcast words.
__host__ __device__ inline int ipm_lane_words(int n, int m, int nl) {
  return ipm_tri(m) + 6 * n + 2 * m + 2 * nl + 2 * IPM_MAX_WPL + 2;
}

// Words of the block's shared structure: 1 / b, the generators' and
// loads' buses, the branches' ends, each bus's A0 columns (CSR).
__host__ __device__ inline int ipm_struct_words(int ng, int nd, int nl,
                                                int nb) {
  return 2 * ng + 2 * nd + 5 * nl + nb + 1;
}

struct IPMArgs {
  // Per-lane inputs, batch-major and contiguous.
  const float* colscale;  // [B, n]
  const float* br_up;     // [B, nl]
  const float* c;         // [B, n]
  const float* b;         // [B, m]
  const float* l;         // [B, n]
  const float* u;         // [B, n]
  // Shared LP structure.
  const float* invb;      // [nl] branch reactances 1/b
  const int* gen_bus;     // [ng]
  const int* load_bus;    // [nd]
  const int* br_from;     // [nl]
  const int* br_to;       // [nl]
  const int* bus_ptr;     // [nb + 1] CSR of A0's rows
  const int* bus_col;     // [ng + nd + 2 nl] columns, ascending per row
  // Outputs, batch-major.
  float* x;           // [B, n]
  float* y;           // [B, m]
  float* zl;          // [B, n]
  float* zu;          // [B, n]
  float* best_x;      // [B, n]
  float* best_score;  // [B]
  int batch, ng, nd, nl, nb, iters, lpb;
  float tau, delta, mu_tol, center_tol;
};

// The block's shared structure, carved from the front of shared memory.
struct Struct {
  int ng, nd, nl, nb, n, m, f_lo, f_hi;
  const float* invb;
  const int *gbus, *dbus, *fbus, *tbus, *bptr, *bcol;
};

// Synchronize the threads of one lane: the warp, or the lane's named
// barrier (ids 1.., 0 being __syncthreads').
template <int WPL>
__device__ __forceinline__ void lane_sync(int bar) {
  if constexpr (WPL == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(32 * WPL) : "memory");
  }
}

// Reduction over the lane's threads; every thread gets the same bits
// (xor butterfly, then the warps' partials in warp order). `red` holds
// two double-buffered slots of WPL words.
template <int OP, int WPL>
__device__ __forceinline__ float lane_reduce(float v, float* red, int& phase,
                                             int bar) {
  v = warp_reduce<OP>(v);
  if constexpr (WPL == 1) {
    return v;
  } else {
    float* r = red + WPL * phase;
    phase ^= 1;
    if ((threadIdx.x & 31) == 0) r[(threadIdx.x >> 5) % WPL] = v;
    lane_sync<WPL>(bar);
    float acc = r[0];
#pragma unroll
    for (int w = 1; w < WPL; ++w) acc = combine<OP>(acc, r[w]);
    return acc;
  }
}

// Value v of the lane's thread `src` to every thread of the lane.
template <int WPL>
__device__ __forceinline__ float lane_bcast(float v, int src, int tid,
                                            float* bc, int& phase, int bar) {
  if constexpr (WPL == 1) {
    return __shfl_sync(0xffffffffu, v, src);
  } else {
    float* slot = bc + phase;
    phase ^= 1;
    if (tid == src) *slot = v;
    lane_sync<WPL>(bar);
    return *slot;
  }
}

// One lane's view: its threads, its shared memory, its row slots.
template <int WPL, int NR, int RS>
struct LaneCtx {
  static constexpr int LT = 32 * WPL;  // threads a lane
  Struct S;
  int tid, bar;
  float *M, *cs, *cc, *lo, *up, *bx, *vn, *wm, *sc, *bru, *wf, *red, *bc;
  int rphase, bphase;

  __device__ int row(int s) const { return tid + s * LT; }
  __device__ int col(int r) const { return tid + r * LT; }
  __device__ void sync() const { lane_sync<WPL>(bar); }
  template <int OP>
  __device__ float reduce(float v) { return lane_reduce<OP, WPL>(v, red, rphase, bar); }
  __device__ float bcast(float v, int src) {
    return lane_bcast<WPL>(v, src, tid, bc, bphase, bar);
  }

  // (A v)_i, v in vn (reference mv_A): balance rows A0 (colscale * v),
  // flow rows invb * v_f - bru * (Mref v_theta). A0 is +-1 where it is
  // not zero: column k of a branch is -1 at its from bus, +1 at its to.
  __device__ float a_row(int i) const {
    const Struct& s = S;
    if (i < s.nb) {
      float acc = 0.0f;
      for (int q = s.bptr[i]; q < s.bptr[i + 1]; ++q) {
        const int k = s.bcol[q];
        const float sgn =
            (k >= s.f_lo && s.fbus[k - s.f_lo] == i) ? -1.0f : 1.0f;
        acc = fmaf(sgn, cs[k] * vn[k], acc);
      }
      return acc;
    }
    const int l = i - s.nb, a = s.fbus[l], b = s.tbus[l];
    const int e1 = min(a, b), e2 = max(a, b);
    float t = 0.0f;   // Mref row l (reference bus 0 masked), ascending
    if (e1 != 0) t = fmaf(e1 == a ? 1.0f : -1.0f, vn[s.f_hi + e1], t);
    if (e2 != 0) t = fmaf(e2 == a ? 1.0f : -1.0f, vn[s.f_hi + e2], t);
    return s.invb[l] * vn[s.f_lo + l] - bru[l] * t;
  }

  // (A' w)_k, w in wm and bru * w_f in wf (reference mtv_A).
  __device__ float at_col(int k) const {
    const Struct& s = S;
    if (k < s.ng) return cs[k] * wm[s.gbus[k]];
    if (k < s.f_lo) return cs[k] * wm[s.dbus[k - s.ng]];
    if (k < s.f_hi) {
      const int l = k - s.f_lo;
      const float t = wm[s.tbus[l]] - wm[s.fbus[l]];
      return fmaf(s.invb[l], wm[s.nb + l], cs[k] * t);
    }
    const int j = k - s.f_hi;
    float q = 0.0f;   // Mref' (bru * w_f) at bus j, ascending branches
    if (j != 0) {
      for (int p = s.bptr[j]; p < s.bptr[j + 1]; ++p) {
        const int kk = s.bcol[p];
        if (kk >= s.f_lo && kk < s.f_hi) {
          const int l = kk - s.f_lo;
          q = fmaf(s.fbus[l] == j ? 1.0f : -1.0f, wf[l], q);
        }
      }
    }
    return cs[k] * 0.0f - q;   // A0's empty theta column, then -Mref'
  }

  // The code of a kernel this long does not fit the instruction cache,
  // so the per-row and per-column bodies run in loops that are not
  // unrolled, through shared scratch, and each thread then picks its
  // slots' results out (each reads only what it wrote: no sync).

  // tm = A v for the row slots; v (n columns, column-striped) is
  // scattered to vn first, the rows' results go through wm.
  __device__ void apply_a(const float (&v)[NR], float (&tm)[RS]) {
    sync();  // earlier readers of vn and wm are done
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (col(r) < S.n) vn[col(r)] = v[r];
    sync();
#pragma unroll 1
    for (int i = tid; i < S.m; i += LT) wm[i] = a_row(i);
#pragma unroll
    for (int s = 0; s < RS; ++s) tm[s] = row(s) < S.m ? wm[row(s)] : 0.0f;
  }

  // out = A' w for the column slots; w (m rows, row-striped), the
  // columns' results go through vn.
  __device__ void apply_at(const float (&w)[RS], float (&out)[NR]) {
    sync();  // earlier readers of wm, wf and vn are done
#pragma unroll
    for (int s = 0; s < RS; ++s) {
      const int i = row(s);
      if (i < S.m) {
        wm[i] = w[s];
        if (i >= S.nb) wf[i - S.nb] = bru[i - S.nb] * w[s];
      }
    }
    sync();
#pragma unroll 1
    for (int k = tid; k < S.n; k += LT) vn[k] = at_col(k);
#pragma unroll
    for (int r = 0; r < NR; ++r) out[r] = col(r) < S.n ? vn[col(r)] : 0.0f;
  }

  // Row i of M = A diag(wb) A' (wb = colscale^2 / d in vn), lower
  // triangle, owned by this thread; returns the diagonal entry. The
  // flow-flow off-diagonals are left without their bru bru' factor,
  // which the scaling pass applies.
  __device__ float form_row(int i) {
    const Struct& s = S;
    float* Mi = M + ipm_tri(i);
    for (int j = 0; j <= i; ++j) Mi[j] = 0.0f;
    if (i < s.nb) {
      float diag = 0.0f;
      for (int q = s.bptr[i]; q < s.bptr[i + 1]; ++q) {
        const int k = s.bcol[q];
        diag += vn[k];
        if (k >= s.f_lo && k < s.f_hi) {   // branch to the other end
          const int l = k - s.f_lo;
          const int o = s.fbus[l] == i ? s.tbus[l] : s.fbus[l];
          if (o < i) Mi[o] -= vn[k];
        }
      }
      return diag;
    }
    const int l = i - s.nb, a = s.fbus[l], b = s.tbus[l];
    const float g = vn[s.f_lo + l] * s.invb[l];
    Mi[a] = -g;
    Mi[b] = g;
    const int ends[2] = {min(a, b), max(a, b)};
    float q = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {     // Mref's shared buses, ascending
      const int e = ends[h];
      if (e == 0) continue;            // reference bus: masked
      const float se = e == a ? 1.0f : -1.0f;
      const float w = vn[s.f_hi + e];
      q += w;
      for (int p = s.bptr[e]; p < s.bptr[e + 1]; ++p) {
        const int kk = s.bcol[p];
        if (kk >= s.f_lo && kk < s.f_lo + l) {
          const int l2 = kk - s.f_lo;
          const float s2 = s.fbus[l2] == e ? 1.0f : -1.0f;
          Mi[s.nb + l2] = fmaf(se * s2, w, Mi[s.nb + l2]);
        }
      }
    }
    return fmaf(s.invb[l], g, q * bru[l] * bru[l]);
  }

  // M = A diag(colscale^2 / d) A', equilibrated to a unit diagonal
  // (scale in scv / sc), regularized by delta, factored in place;
  // rec = 1 / L_ii for the row slots.
  __device__ void form_and_factor(const float (&d)[NR], float delta,
                                  float (&scv)[RS], float (&rec)[RS]) {
    const int m = S.m;
    sync();  // earlier readers of vn are done
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int k = col(r);
      if (k < S.n) vn[k] = cs[k] * cs[k] / d[r];
    }
    sync();
#pragma unroll 1
    for (int i = tid; i < m; i += LT) {
      const float diag = form_row(i);
      M[ipm_tri(i) + i] = diag;
      sc[i] = rsqrtf(nmax(diag, 1e-30f));
    }
    sync();
#pragma unroll
    for (int s = 0; s < RS; ++s) scv[s] = row(s) < m ? sc[row(s)] : 0.0f;
#pragma unroll 1
    for (int i = tid; i < m; i += LT) {
      const float si = sc[i];
      {
        float* Mi = M + ipm_tri(i);
        const bool flow = i >= S.nb;
        const float bi = flow ? bru[i - S.nb] : 1.0f;
        for (int j0 = 0; j0 < i; j0 += IPM_JC) {   // loads, then stores
          float v[IPM_JC], sj[IPM_JC], bj[IPM_JC];
#pragma unroll
          for (int q = 0; q < IPM_JC; ++q) {
            const int j = min(j0 + q, i - 1);
            v[q] = Mi[j];
            sj[q] = sc[j];
            const float b = bru[max(j - S.nb, 0)];
            bj[q] = flow && j >= S.nb ? b : 1.0f;
          }
#pragma unroll
          for (int q = 0; q < IPM_JC; ++q) {
            const int j = j0 + q;
            if (flow && j >= S.nb) v[q] = v[q] * bi * bj[q];
            if (j < i) Mi[j] = v[q] * si * sj[q];
          }
        }
        Mi[i] = Mi[i] * si * si + delta;
      }
    }
    factor(rec);
  }

  // l_jk of row j (slot s0's rows) from its owner: a shuffle of the
  // owner's register, or (two warps) the stored column.
  __device__ __forceinline__ float col_entry(const float (&l)[RS], int s0,
                                             int j, int k) const {
    if constexpr (WPL == 1)
      return __shfl_sync(0xffffffffu, l[s0], j - s0 * LT);
    else
      return k < S.m ? M[ipm_tri(j) + k] : 0.0f;
  }

  // Trailing update of the columns j0 .. j0 + JC - 1 (rows j owned by
  // slot s0, j < jend) by the panel's KB columns: a_ij -= l_iq l_jq for
  // q ascending, this thread's rows i >= j. One load and one store an
  // entry for KB pivots, and every load of the round issued before any
  // store (the compiler cannot tell the rows apart, so a load-FMA-store
  // at a time would pay a shared-memory round trip an entry).
  template <int JC>
  __device__ __forceinline__ void update_cols(int K, int j0, int jend, int s0,
                                              const float (&lq)[IPM_KB][RS],
                                              const int (&toff)[RS],
                                              const int (&ilim)[RS],
                                              const int (&rowc)[RS]) {
    float lj[JC][IPM_KB], a[RS][JC];
#pragma unroll
    for (int c = 0; c < JC; ++c) {
      const int j = min(j0 + c, jend - 1);
#pragma unroll
      for (int q = 0; q < IPM_KB; ++q) lj[c][q] = col_entry(lq[q], s0, j, K + q);
      // Unconditional loads from an address always inside the row (a
      // predicated load would serialize on its temporary register); only
      // the stores are predicated.
#pragma unroll
      for (int s = 0; s < RS; ++s)
        a[s][c] = s >= s0 ? M[toff[s] + min(j0 + c, rowc[s])] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < JC; ++c) {
#pragma unroll
      for (int s = 0; s < RS; ++s) {
        if (s >= s0 && ilim[s] >= j0 + c && j0 + c < jend) {
          float v = a[s][c];
#pragma unroll
          for (int q = 0; q < IPM_KB; ++q) v = fmaf(-lq[q][s], lj[c][q], v);
          M[toff[s] + j0 + c] = v;
        }
      }
    }
  }

  // Right-looking Cholesky of the packed lower triangle with the plain
  // version's arithmetic (inv = rsqrt(max(a_kk, PIVOT_FLOOR)), a_ij -=
  // (a_ik inv)(a_jk inv), column k scaled by inv), blocked by IPM_KB
  // pivots; each entry still takes its updates in pivot order. For a
  // panel of IPM_KB columns every thread factors the panel's diagonal
  // block itself (the same operations in the same order as its owners
  // would, so the same bits: no broadcast chain), then its own rows'
  // panel entries in registers; the panel is stored and the columns
  // right of it take its IPM_KB updates at once. A last panel past m is
  // padded with zero columns (l = 0 changes nothing).
  __device__ void factor(float (&rec)[RS]) {
    const int m = S.m;
    int toff[RS], ilim[RS], rowc[RS];
#pragma unroll
    for (int s = 0; s < RS; ++s) {
      rowc[s] = min(row(s), m - 1);         // a row inside M, to load from
      toff[s] = ipm_tri(rowc[s]);
      ilim[s] = row(s) < m ? row(s) : -1;   // rows i >= j hold column j
      rec[s] = 1.0f;
    }
    for (int K = 0; K < m; K += IPM_KB) {
      sync();  // the panel's rows are updated and visible
      float dg[IPM_KB][IPM_KB], inv[IPM_KB], lq[IPM_KB][RS];
#pragma unroll
      for (int q = 0; q < IPM_KB; ++q) {
        const int kq = min(K + q, m - 1);
#pragma unroll
        for (int r = 0; r <= q; ++r) {
          const float v = M[ipm_tri(kq) + min(K + r, kq)];
          dg[q][r] = K + q < m ? v : 0.0f;
        }
#pragma unroll
        for (int s = 0; s < RS; ++s) {
          const float v = M[toff[s] + min(K + q, rowc[s])];
          lq[q][s] = ilim[s] >= K + q ? v : 0.0f;
        }
      }
      // The diagonal block, right-looking (rows K + q2 > K + q).
#pragma unroll
      for (int q = 0; q < IPM_KB; ++q) {
        inv[q] = rsqrtf(nmax(dg[q][q], PIVOT_FLOOR));
#pragma unroll
        for (int r = q; r < IPM_KB; ++r) dg[r][q] *= inv[q];
#pragma unroll
        for (int q2 = q + 1; q2 < IPM_KB; ++q2)
#pragma unroll
          for (int r = q2; r < IPM_KB; ++r)
            dg[r][q2] = fmaf(-dg[r][q], dg[q2][q], dg[r][q2]);
      }
      // This thread's rows: column q takes the pivots before it, in
      // order, then its scale; L_kk stays in rec.
#pragma unroll
      for (int s = 0; s < RS; ++s) {
        const int dq = row(s) - K;           // its row in the block, if any
#pragma unroll
        for (int q = 0; q < IPM_KB; ++q) {
          if (dq >= 0 && dq < IPM_KB) {
#pragma unroll
            for (int r = q; r < IPM_KB; ++r)   // dg[dq][q], static indices
              if (dq == r) lq[q][s] = dg[r][q];
            if (dq == q) rec[s] = dg[q][q];
          } else {
#pragma unroll
            for (int q0 = 0; q0 < q; ++q0)
              lq[q][s] = fmaf(-lq[q0][s], dg[q][q0], lq[q][s]);
            lq[q][s] *= inv[q];
          }
          if (ilim[s] < K + q) lq[q][s] = 0.0f;  // above the diagonal
        }
      }
      sync();  // every thread has read the diagonal block
#pragma unroll
      for (int q = 0; q < IPM_KB; ++q)
#pragma unroll
        for (int s = 0; s < RS; ++s)
          if (ilim[s] > K + q) M[toff[s] + K + q] = lq[q][s];
      if constexpr (WPL > 1) sync();  // the panel's columns are visible
      int j = K + IPM_KB;
#pragma unroll
      for (int s0 = 0; s0 < RS; ++s0) {   // rows j owned by slot s0
        const int jend = min(m, (s0 + 1) * LT);
        for (; j < jend; j += IPM_JC)
          update_cols<IPM_JC>(K, j, jend, s0, lq, toff, ilim, rowc);
        j = max(jend, K + IPM_KB);
      }
    }
    sync();
#pragma unroll
    for (int s = 0; s < RS; ++s) rec[s] = 1.0f / rec[s];
  }

  // z <- (S L L' S)^-1 z for the row slots (factor in M, S = scv):
  // forward and back substitution as shuffle chains.
  __device__ void solve(float (&z)[RS], const float (&scv)[RS],
                        const float (&rec)[RS]) {
    const int m = S.m;
    int toff[RS], rowc[RS];
#pragma unroll
    for (int s = 0; s < RS; ++s) {
      z[s] = scv[s] * z[s];
      rowc[s] = min(row(s), m - 1);   // loads stay inside M (see update_cols)
      toff[s] = ipm_tri(rowc[s]);
    }
    int k = 0;
#pragma unroll
    for (int s0 = 0; s0 < RS; ++s0) {     // L y = z
      const int kend = min(m, (s0 + 1) * LT);
#pragma unroll 1
      for (; k < kend; ++k) {
        float l[RS];
#pragma unroll
        for (int s = s0; s < RS; ++s) l[s] = M[toff[s] + min(k, rowc[s])];
        const float yk = bcast(z[s0] * rec[s0], k - s0 * LT);
#pragma unroll
        for (int s = s0; s < RS; ++s) {
          const int i = row(s);
          const float upd = fmaf(-l[s], yk, z[s]);
          z[s] = i == k ? yk : (i > k && i < m ? upd : z[s]);
        }
      }
    }
    k = m - 1;
#pragma unroll
    for (int s0 = RS - 1; s0 >= 0; --s0) {  // L' x = y
#pragma unroll 1
      for (; k >= s0 * LT; --k) {
        const float* Lk = M + ipm_tri(k);
        float l[RS];
#pragma unroll
        for (int s = 0; s <= s0; ++s) l[s] = Lk[min(row(s), k)];
        const float xk = bcast(z[s0] * rec[s0], k - s0 * LT);
#pragma unroll
        for (int s = 0; s <= s0; ++s) {
          const int i = row(s);
          const float upd = fmaf(-l[s], xk, z[s]);
          z[s] = i == k ? xk : (i < k ? upd : z[s]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < RS; ++s) z[s] = scv[s] * z[s];
  }
};

template <int WPL, int NR, int RS>
__global__ void __launch_bounds__(IPM_MAX_LPB * 32 * WPL,
                                  NR * WPL <= 4 ? 16 / (IPM_MAX_LPB * WPL) : 1)
fused_ipm_kernel(IPMArgs p) {
  using Ctx = LaneCtx<WPL, NR, RS>;
  constexpr int LT = Ctx::LT;
  extern __shared__ float4 ipm_smem4[];
  float* smem = reinterpret_cast<float*>(ipm_smem4);
  Ctx C;
  Struct& S = C.S;
  S.ng = p.ng; S.nd = p.nd; S.nl = p.nl; S.nb = p.nb;
  S.n = p.ng + p.nd + p.nl + p.nb;
  S.m = p.nb + p.nl;
  S.f_lo = p.ng + p.nd;
  S.f_hi = S.f_lo + p.nl;
  const int n = S.n, m = S.m, nl = S.nl, nb = S.nb;

  // The shared structure, staged once per block.
  float* invb = smem;
  int* gbus = reinterpret_cast<int*>(smem + nl);
  int* dbus = gbus + p.ng;
  int* fbus = dbus + p.nd;
  int* tbus = fbus + nl;
  int* bptr = tbus + nl;
  int* bcol = bptr + nb + 1;
  const int nnz = p.ng + p.nd + 2 * nl;
  for (int t = threadIdx.x; t < nl; t += blockDim.x) {
    invb[t] = p.invb[t];
    fbus[t] = p.br_from[t];
    tbus[t] = p.br_to[t];
  }
  for (int t = threadIdx.x; t < p.ng; t += blockDim.x) gbus[t] = p.gen_bus[t];
  for (int t = threadIdx.x; t < p.nd; t += blockDim.x) dbus[t] = p.load_bus[t];
  for (int t = threadIdx.x; t <= nb; t += blockDim.x) bptr[t] = p.bus_ptr[t];
  for (int t = threadIdx.x; t < nnz; t += blockDim.x) bcol[t] = p.bus_col[t];
  S.invb = invb; S.gbus = gbus; S.dbus = dbus; S.fbus = fbus; S.tbus = tbus;
  S.bptr = bptr; S.bcol = bcol;

  const int gl = threadIdx.x / LT;
  C.tid = threadIdx.x % LT;
  C.bar = 1 + gl;
  C.rphase = C.bphase = 0;
  const int lane = blockIdx.x * p.lpb + gl;
  float* s = smem + ipm_struct_words(p.ng, p.nd, nl, nb)
             + gl * ipm_lane_words(n, m, nl);
  C.M = s; s += ipm_tri(m);
  C.cs = s; s += n;
  C.cc = s; s += n;
  C.lo = s; s += n;
  C.up = s; s += n;
  C.bx = s; s += n;
  C.vn = s; s += n;
  C.wm = s; s += m;
  C.sc = s; s += m;
  C.bru = s; s += nl;
  C.wf = s; s += nl;
  C.red = s;
  C.bc = s + 2 * WPL;
  __syncthreads();  // the structure is staged: the block's only barrier
  if (lane >= p.batch) return;  // lane-uniform; the lane's own syncs only

  const size_t ln = (size_t)lane * n, lm = (size_t)lane * m,
               ll = (size_t)lane * nl;
  float x[NR], zl[NR], zu[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int k = C.col(r);
    x[r] = 0.0f;
    if (k < n) {
      C.cs[k] = p.colscale[ln + k];
      C.cc[k] = p.c[ln + k];
      C.lo[k] = p.l[ln + k];
      C.up[k] = p.u[ln + k];
      x[r] = 0.5f * (C.lo[k] + C.up[k]);
      C.bx[k] = x[r];
    }
    zl[r] = 1.0f;
    zu[r] = 1.0f;
  }
  for (int t = C.tid; t < nl; t += LT) C.bru[t] = p.br_up[ll + t];
  float bv[RS], y[RS];
#pragma unroll
  for (int s2 = 0; s2 < RS; ++s2) {
    const int i = C.row(s2);
    bv[s2] = i < m ? p.b[lm + i] : 0.0f;
    y[s2] = 0.0f;
  }
  C.sync();

  const float inv2n = 1.0f / (2.0f * n);
  const float big = 1e30f;
  float best = INFINITY;
  for (int it = 0; it < p.iters; ++it) {
    float sl[NR], su[NR], tn[NR], rd[NR];
    float tm[RS], rp[RS];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int k = C.col(r);
      sl[r] = k < n ? nmax(x[r] - C.lo[k], 1e-12f) : 1.0f;
      su[r] = k < n ? nmax(C.up[k] - x[r], 1e-12f) : 1.0f;
    }
    C.apply_a(x, tm);
    C.apply_at(y, tn);
    float loc_rp = 0.0f, loc_mu = 0.0f;
#pragma unroll
    for (int s2 = 0; s2 < RS; ++s2) {
      rp[s2] = bv[s2] - tm[s2];
      if (C.row(s2) < m) loc_rp = fmaxf(loc_rp, fabsf(rp[s2]));
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int k = C.col(r);
      rd[r] = k < n ? C.cc[k] - tn[r] - zl[r] + zu[r] : 0.0f;
      if (k < n) loc_mu += sl[r] * zl[r] + su[r] * zu[r];
    }
    const float mu = C.template reduce<kSum>(loc_mu) * inv2n;
    const float score = mu + C.template reduce<kMax>(loc_rp);
    if (score < best) {  // lane-uniform
      best = score;
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (C.col(r) < n) C.bx[C.col(r)] = x[r];
    }
    if (mu < p.mu_tol) break;  // frozen: the state never changes again

    float d[NR], rcl[NR], rcu[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      d[r] = nclip(zl[r] / sl[r] + zu[r] / su[r], 1e-6f, 1e10f);
      rcl[r] = -sl[r] * zl[r];
      rcu[r] = -su[r] * zu[r];
    }
    float scv[RS], rec[RS];
    C.form_and_factor(d, p.delta, scv, rec);
    const bool centering = mu < p.center_tol;

    // Predictor (affine) step, then the corrector: one Newton solve of
    // the reduced KKT system each (reference `newton`) and the
    // fraction-to-boundary step lengths (`max_step`), in a loop of two
    // passes, not unrolled (one copy of the code). The predictor is
    // computed even when centering, as the reference does, so a
    // non-finite affine direction still freezes the lane through
    // gate * dxa.
    float dx[NR], dzl[NR], dzu[NR], dy[RS], ap = 0.0f, ad = 0.0f;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      float rhat[NR], t[NR], at[RS];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        rhat[r] = rd[r] - rcl[r] / sl[r] + rcu[r] / su[r];
        t[r] = rhat[r] / d[r];
      }
      C.apply_a(t, at);
#pragma unroll
      for (int s2 = 0; s2 < RS; ++s2) dy[s2] = rp[s2] + at[s2];
      C.solve(dy, scv, rec);
      C.apply_at(dy, t);
      float pa = big, da = big;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        dx[r] = (t[r] - rhat[r]) / d[r];
        dzl[r] = (rcl[r] - zl[r] * dx[r]) / sl[r];
        dzu[r] = (rcu[r] + zu[r] * dx[r]) / su[r];
        if (C.col(r) >= n) continue;
        const float v = dx[r];
        const float t1 = v < 0.0f ? -sl[r] / fminf(v, -1e-30f) : big;
        const float t2 = v > 0.0f ? su[r] / fmaxf(v, 1e-30f) : big;
        pa = fminf(pa, fminf(t1, t2));
        const float e1 = dzl[r] < 0.0f ? -zl[r] / fminf(dzl[r], -1e-30f) : big;
        const float e2 = dzu[r] < 0.0f ? -zu[r] / fminf(dzu[r], -1e-30f) : big;
        da = fminf(da, fminf(e1, e2));
      }
      ap = fminf(p.tau * C.template reduce<kMin>(pa), 1.0f);
      ad = fminf(p.tau * C.template reduce<kMin>(da), 1.0f);
      if (pass == 1) break;
      // After the predictor: the centering and the corrector's rhs.
      float loc = 0.0f;
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (C.col(r) < n)
          loc += (sl[r] + ap * dx[r]) * (zl[r] + ad * dzl[r])
                 + (su[r] - ap * dx[r]) * (zu[r] + ad * dzu[r]);
      const float mu_aff = C.template reduce<kSum>(loc) * inv2n;
      const float ratio = mu_aff / nmax(mu, 1e-12f);
      const float sigma =
          centering ? 0.5f : nclip(ratio * ratio * ratio, 0.0f, 1.0f);
      const float gate = centering ? 0.0f : 1.0f;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        rcl[r] = sigma * mu - sl[r] * zl[r] - gate * dx[r] * dzl[r];
        rcu[r] = sigma * mu - su[r] * zu[r] + gate * dx[r] * dzu[r];
      }
    }
    const float damp = centering ? 0.9f : 1.0f;
    ap *= damp;
    ad *= damp;

    // Candidate iterate (into the direction's registers).
    float fin = 1.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int k = C.col(r);
      if (k >= n) continue;
      const float lo = C.lo[k], up = C.up[k];
      const float margin = 1e-9f * nmax(up - lo, 1e-12f);
      dx[r] = nclip(x[r] + ap * dx[r], lo + margin, up - margin);
      dzl[r] = nmax(zl[r] + ad * dzl[r], 1e-12f);
      dzu[r] = nmax(zu[r] + ad * dzu[r], 1e-12f);
      if (!(isfinite(dx[r]) && isfinite(dzl[r]) && isfinite(dzu[r])))
        fin = 0.0f;
    }
    float yn[RS];
#pragma unroll
    for (int s2 = 0; s2 < RS; ++s2) {
      yn[s2] = y[s2] + ad * dy[s2];
      if (C.row(s2) < m && !isfinite(yn[s2])) fin = 0.0f;
    }
    if (C.template reduce<kMin>(fin) < 0.5f) break;  // frozen, state kept
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (C.col(r) < n) {
        x[r] = dx[r];
        zl[r] = dzl[r];
        zu[r] = dzu[r];
      }
    }
#pragma unroll
    for (int s2 = 0; s2 < RS; ++s2) y[s2] = yn[s2];
  }

#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int k = C.col(r);
    if (k < n) {
      p.x[ln + k] = x[r];
      p.zl[ln + k] = zl[r];
      p.zu[ln + k] = zu[r];
      p.best_x[ln + k] = C.bx[k];
    }
  }
#pragma unroll
  for (int s2 = 0; s2 < RS; ++s2)
    if (C.row(s2) < m) p.y[lm + C.row(s2)] = y[s2];
  if (C.tid == 0) p.best_score[lane] = best;
}

using IpmKernel = void (*)(IPMArgs);

// The instance for a shape: one warp a lane at m <= 64 and n <= 128 (the
// RTS-24 path at 2,048 lanes: two row slots, four column slots), else at
// m <= 72 and n <= 256; two warps a lane at m <= 64 and n <= 128 (the
// RTS-24 path at 256 lanes). Index into the per-instance state, or -1.
inline int ipm_instance(int wpl, int m, int n, IpmKernel* kern) {
  if (wpl == 1 && m <= 64 && n <= 128) {
    *kern = fused_ipm_kernel<1, 4, 2>;
    return 0;
  }
  if (wpl == 1 && m <= MAXM && n <= 256) {
    *kern = fused_ipm_kernel<1, 8, 3>;
    return 1;
  }
  if (wpl == 2 && m <= 64 && n <= 128) {
    *kern = fused_ipm_kernel<2, 2, 1>;
    return 2;
  }

  return -1;
}

// Allow the instance the device's whole opt-in shared memory and the
// largest shared carveout, once per process and device.
inline cudaError_t ipm_prepare(int inst, IpmKernel kern) {
  static uint64_t ready[3] = {0, 0, 0};
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
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) ready[inst] |= 1ull << dev;
  return err;
}

}  // namespace psra

// C interface (bound with ctypes). Launches ceil(batch / lanes_per_block)
// blocks of lanes_per_block x 32 x warps_per_lane threads on `stream`
// with smem_bytes of dynamic shared memory (which must equal the layout
// above: ops/ipm_fused.py::launch_shape computes both), allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// no instance takes or a shared-memory size that disagrees).
extern "C" int psra_fused_ipm(
    const float* colscale, const float* br_up, const float* c,
    const float* b, const float* l, const float* u, const float* invb,
    const int* gen_bus, const int* load_bus, const int* br_from,
    const int* br_to, const int* bus_ptr, const int* bus_col,
    float* x, float* y, float* zl, float* zu, float* best_x,
    float* best_score, int batch, int ng, int nd, int nl, int nb,
    int iters, int lanes_per_block, int warps_per_lane, int smem_bytes,
    float tau, float delta, float mu_tol, float center_tol, void* stream) {
  const int n = ng + nd + nl + nb, m = nb + nl;
  psra::IpmKernel kern = nullptr;
  const int inst = psra::ipm_instance(warps_per_lane, m, n, &kern);
  const int want = (int)sizeof(float) *
      (psra::ipm_struct_words(ng, nd, nl, nb)
       + lanes_per_block * psra::ipm_lane_words(n, m, nl));
  if (inst < 0 || lanes_per_block < 1 || lanes_per_block > psra::IPM_MAX_LPB
      || smem_bytes != want)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = psra::ipm_prepare(inst, kern);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaGetLastError();
  psra::IPMArgs p{colscale, br_up, c, b, l, u, invb, gen_bus, load_bus,
                  br_from, br_to, bus_ptr, bus_col, x, y, zl, zu, best_x,
                  best_score, batch, ng, nd, nl, nb, iters, lanes_per_block,
                  tau, delta, mu_tol, center_tol};
  const int grid = (batch + lanes_per_block - 1) / lanes_per_block;
  kern<<<grid, lanes_per_block * 32 * warps_per_lane, smem_bytes,
         (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Blocks of the instance for (m, n, warps_per_lane) that one SM holds at
// once with lanes_per_block lanes and smem_bytes of shared memory (the
// occupancy API), in *blocks; returns a CUDA error code.
extern "C" int psra_fused_ipm_occupancy(int m, int n, int lanes_per_block,
                                        int warps_per_lane, int smem_bytes,
                                        int* blocks) {
  psra::IpmKernel kern = nullptr;
  const int inst = psra::ipm_instance(warps_per_lane, m, n, &kern);
  if (inst < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = psra::ipm_prepare(inst, kern);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kern, lanes_per_block * 32 * warps_per_lane, smem_bytes);
  return (int)err;
}
