// B5: Lowe-ratio match counts of every listed image pair, both directions,
// in one launch.
//
// Replaces computervisionimagestich2_tpu/ops/pallas_distance.py::
// pair_match_counts_pallas (_pair_counts_kernel). Contract: the per-pair
// scan of models/registration.py::all_pairs_match_counts on the exact-L1
// path. For pair p = (i, j), out[p, 0] counts the valid descriptors of
// image j (queries) whose nearest / second-nearest L1 distance over image
// i's valid descriptors (references) is below `ratio` — the reference's
// getImgPair(i, j) size — and out[p, 1] the same with the roles swapped.
//
// What bounds it on the H100: arithmetic, as in B4: per pair and direction
// nq * nr * 128 |a - b| + add pairs on the FP32 pipes. The TPU kernel kept
// one image's whole reference block in VMEM (hence its cap <= 12288 limit)
// and got the reverse direction from the same tiles through a running
// per-reference top-2 carried across its sequential grid. Hopper blocks run
// in no order, so this simple design computes each direction on its own:
// grid (query tile of 128, pair, direction), one query per thread, the
// other image's references streamed through shared memory in 32-row tiles
// by the loop B4 uses (cvs::l1_top2, l1.cuh), so there is no capacity limit
// and the counts equal two B4 launches bit for bit. Each block counts its
// passes with __ballot_sync / __popc and adds them with one integer
// atomicAdd: integer addition is order-free, so the counts are
// deterministic. Masks and the loop bound are read on the device.
#include "api.h"
#include "l1.cuh"

namespace {

using namespace cvs;

__global__ void __launch_bounds__(kQueries)
pair_counts_kernel(const float* __restrict__ desc,
                   const unsigned char* __restrict__ valid, int cap,
                   const int* __restrict__ pairs, float ratio,
                   int* __restrict__ out) {
  __shared__ int warp_n[kQueries / 32];
  const int p = blockIdx.y;
  const int dir = blockIdx.z;
  const int img_i = pairs[2 * p];
  const int img_j = pairs[2 * p + 1];
  const int qi = dir == 0 ? img_j : img_i;  // query image
  const int ri = dir == 0 ? img_i : img_j;  // reference image
  const unsigned char* qmask = valid + (long long)qi * cap;
  const unsigned char* rmask = valid + (long long)ri * cap;
  const int q = blockIdx.x * kQueries + threadIdx.x;
  const bool live = q < cap && qmask[q];
  if (!__syncthreads_or(live)) return;  // no valid query: uniform exit
  const int nr = live_bound<kQueries>(rmask, cap);
  float qv[kFeat];
  load_query(desc + (long long)qi * cap * kFeat, q, live, qv);
  const Top2 t = l1_top2(qv, desc + (long long)ri * cap * kFeat, rmask, nr);
  const bool ok = live && t.d2 < kBig && (t.d1 / t.d2) < ratio;
  const unsigned hits = __ballot_sync(0xffffffffu, ok);
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = __popc(hits);
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
#pragma unroll
    for (int k = 0; k < kQueries / 32; ++k) n += warp_n[k];
    if (n) atomicAdd(&out[2 * p + dir], n);
  }
}

}  // namespace

extern "C" cudaError_t cvs_pair_match_counts(const float* desc,
                                             const unsigned char* valid,
                                             int cap, const int* pairs,
                                             int n_pairs, float ratio,
                                             int* out, cudaStream_t stream) {
  if (n_pairs == 0 || cap == 0) return cudaSuccess;
  const dim3 grid((unsigned)((cap + kQueries - 1) / kQueries),
                  (unsigned)n_pairs, 2u);
  pair_counts_kernel<<<grid, kQueries, 0, stream>>>(desc, valid, cap, pairs,
                                                    ratio, out);
  return cudaGetLastError();
}
