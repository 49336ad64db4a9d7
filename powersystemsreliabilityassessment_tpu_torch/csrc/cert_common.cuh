// The network buffers both tier-1 certificate kernels read, K4
// (fused_sampler_cert.cu) and K5 (certify_kernel.cu): the System's
// matrices and index arrays as two flat device buffers (net_unpack), and
// the STAGE_* bits that say which matrices a block keeps in shared
// memory. The lanes' own device code is in lane_common.cuh.
//
// Replaces: the operands the TPU Pallas kernels of
//   powersystemsreliabilityassessment_tpu/ops/certify_kernel.py and
//   ops/fused_sampler_cert.py take as [<=128, <=128] blocks.
//
// What bounds it, and what the design does about it: nothing runs here;
// the one-hot incidence matrices become index arrays (a unit's bus;
// per-bus CSR lists of units and loads), so their products are exact
// gathers and short sums.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

#include "common.cuh"

namespace psra {

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

}  // namespace psra
