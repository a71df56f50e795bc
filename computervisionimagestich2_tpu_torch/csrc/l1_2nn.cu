// B4 and B7: exact L1 two-nearest-neighbour search over 128-d SIFT
// descriptors, one direction.
//
// Replaces computervisionimagestich2_tpu/ops/pallas_distance.py::
// two_nearest_l1_pallas (_kernel, B7) and, launched twice with the roles
// swapped, two_nearest_l1_bidir_pallas (_bidir_kernel, B4). Contract:
// ops/distance.py::two_nearest on the exact-L1 path: for every valid query
// row, the smallest and second-smallest L1 distance to the valid reference
// rows and the index of the nearest; invalid queries get d1 = d2 = BIG.
// (The TPU's bidirectional kernel carried the per-reference top-2 across its
// sequential grid in VMEM scratch; Hopper blocks run in no order and cannot,
// so sharing one distance pass between both directions is later work.)
//
// Both masks are read on the device, row by row, so any mask is honoured
// and the host never synchronises: a block whose queries are all invalid
// writes BIG and exits, and the reference loop stops one past the last
// valid reference row. For the prefix-compacted masks of the main path that
// bound is the live count, and dead rows cost nothing.
//
// What bounds it on the H100: arithmetic. nq * nr * 128 |a - b| + add pairs
// on the FP32 pipes (no tensor-core form of L1 exists); device memory
// traffic is only the two descriptor sets. Simple design: one thread owns
// one query, a block of 128 queries walks reference tiles of 32 rows staged
// in shared memory (the loop is cvs::l1_top2 in l1.cuh, shared with B5).
#include "api.h"
#include "l1.cuh"

namespace {

using namespace cvs;

__global__ void __launch_bounds__(kQueries)
l1_two_nearest_kernel(const float* __restrict__ qry,
                      const float* __restrict__ ref,
                      const unsigned char* __restrict__ qry_valid,
                      const unsigned char* __restrict__ ref_valid, int nb,
                      int na, float* __restrict__ d1_out,
                      float* __restrict__ d2_out, int* __restrict__ i1_out) {
  const int q = blockIdx.x * kQueries + threadIdx.x;
  const bool live = q < nb && qry_valid[q];
  if (!__syncthreads_or(live)) {  // no valid query in the block: uniform exit
    if (q < nb) {
      d1_out[q] = kBig;
      d2_out[q] = kBig;
      i1_out[q] = 0;
    }
    return;
  }
  const int nr = live_bound(ref_valid, na);
  float qv[kFeat];
  load_query(qry, q, live, qv);
  const Top2 t = l1_top2(qv, ref, ref_valid, nr);
  if (q < nb) {
    d1_out[q] = live ? t.d1 : kBig;
    d2_out[q] = live ? t.d2 : kBig;
    i1_out[q] = live ? t.i1 : 0;
  }
}

}  // namespace

extern "C" cudaError_t cvs_l1_two_nearest(const float* qry, const float* ref,
                                          const unsigned char* qry_valid,
                                          const unsigned char* ref_valid,
                                          int nb, int na, float* d1, float* d2,
                                          int* i1, cudaStream_t stream) {
  if (nb == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((nb + kQueries - 1) / kQueries);
  l1_two_nearest_kernel<<<blocks, kQueries, 0, stream>>>(
      qry, ref, qry_valid, ref_valid, nb, na, d1, d2, i1);
  return cudaGetLastError();
}
