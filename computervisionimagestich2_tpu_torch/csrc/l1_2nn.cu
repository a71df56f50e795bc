// B4: exact L1 two-nearest-neighbour search over 128-d SIFT descriptors.
//
// Replaces computervisionimagestich2_tpu/ops/pallas_distance.py::
// two_nearest_l1_bidir_pallas (_bidir_kernel). Contract:
// ops/distance.py::two_nearest_bidir on the exact-L1 path. This file holds
// ONE direction: for every live query row, the smallest and second-smallest
// L1 distance to the live reference rows and the index of the nearest. The
// wrapper launches it twice, the second time with the roles swapped. (The
// TPU kernel carried the per-reference top-2 across its sequential grid in
// VMEM scratch; Hopper blocks run in no order and cannot, so sharing one
// distance pass between both directions is later work.)
//
// Rows are prefix-compacted: only the first counts[0] queries and
// counts[1] references are live, and both counts are read from device
// memory, so the host never synchronises and dead rows cost nothing.
//
// What bounds it on the H100: arithmetic. nq * nr * 128 |a - b| + add pairs
// on the FP32 pipes (no tensor-core form of L1 exists); device memory
// traffic is only the two descriptor sets. Simple design: one thread owns
// one query (its 128 floats in registers), a block of 128 queries walks
// reference tiles of 32 rows staged in shared memory, and every thread
// reads the same shared address at a time (a broadcast, no bank
// conflicts). The running (d1, d2, i1) is updated with a strict `<` in
// ascending reference order, so the lowest index wins ties and a tie at d1
// gives d2 = d1 — the reference's argmin semantics.
#include "api.h"

namespace {

constexpr int kFeat = 128;     // descriptor length
constexpr int kQueries = 128;  // queries per block, one per thread
constexpr int kRefTile = 32;   // reference rows per shared-memory tile
constexpr float kBig = 3.0e38f;

__global__ void __launch_bounds__(kQueries)
l1_two_nearest_kernel(const float* __restrict__ qry,
                      const float* __restrict__ ref,
                      const int* __restrict__ counts, int nb,
                      float* __restrict__ d1_out, float* __restrict__ d2_out,
                      int* __restrict__ i1_out) {
  __shared__ __align__(16) float tile[kRefTile][kFeat];
  const int nq = counts[0];
  const int nr = counts[1];
  const int q = blockIdx.x * kQueries + threadIdx.x;
  if (blockIdx.x * kQueries >= nq) {  // whole block dead: uniform exit
    if (q < nb) {
      d1_out[q] = kBig;
      d2_out[q] = kBig;
      i1_out[q] = 0;
    }
    return;
  }
  const bool live = q < nq;
  float qv[kFeat];
#pragma unroll
  for (int f = 0; f < kFeat; f += 4) {
    const float4 v = live ? reinterpret_cast<const float4*>(
                                qry + (long long)q * kFeat)[f / 4]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    qv[f] = v.x;
    qv[f + 1] = v.y;
    qv[f + 2] = v.z;
    qv[f + 3] = v.w;
  }
  float d1 = kBig, d2 = kBig;
  int i1 = 0;
  for (int j0 = 0; j0 < nr; j0 += kRefTile) {
    __syncthreads();  // previous tile fully consumed
    for (int e = threadIdx.x; e < kRefTile * kFeat / 4; e += kQueries) {
      const int row = e / (kFeat / 4);
      const int col = e - row * (kFeat / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + row < nr)
        v = reinterpret_cast<const float4*>(ref +
                                            (long long)(j0 + row) * kFeat)[col];
      reinterpret_cast<float4*>(&tile[row][0])[col] = v;
    }
    __syncthreads();
    const int jn = min(kRefTile, nr - j0);
    for (int jj = 0; jj < jn; ++jj) {
      float d = 0.f;
#pragma unroll
      for (int f = 0; f < kFeat; ++f) d += fabsf(qv[f] - tile[jj][f]);
      if (d < d1) {
        d2 = d1;
        d1 = d;
        i1 = j0 + jj;
      } else if (d < d2) {
        d2 = d;
      }
    }
  }
  if (q < nb) {
    d1_out[q] = live ? d1 : kBig;
    d2_out[q] = live ? d2 : kBig;
    i1_out[q] = live ? i1 : 0;
  }
}

}  // namespace

extern "C" cudaError_t cvs_l1_two_nearest(const float* qry, const float* ref,
                                          const int* counts, int nb,
                                          float* d1, float* d2, int* i1,
                                          cudaStream_t stream) {
  if (nb == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((nb + kQueries - 1) / kQueries);
  l1_two_nearest_kernel<<<blocks, kQueries, 0, stream>>>(qry, ref, counts, nb,
                                                         d1, d2, i1);
  return cudaGetLastError();
}
