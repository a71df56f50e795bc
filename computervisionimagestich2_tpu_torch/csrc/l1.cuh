// The exact L1 2-NN inner loop of kernel B7 (l1_2nn.cu), and what every L1
// kernel of the port shares: the descriptor length, BIG, the top-2 record
// and the live bound of a mask. Every L1 kernel (the tile pass of B4 and B5
// in l1_tile.cuh too) sums |q - r| over the 128 features in ascending order
// into one float from 0, so they all give the same distance bits, and an
// image pair's match-graph count (B5) equals the count of one B4 launch on
// it.
//
// Layout of the loop: a block of kQueries threads, one query per thread, its
// 128 floats in registers; reference rows staged kRefTile at a time in
// shared memory, every thread reading the same shared address at a time (a
// broadcast). Masks are honoured row by row: a reference row whose mask is
// false never wins, and the loop stops one past the last true mask entry.
#pragma once
#include <cuda_runtime.h>

namespace cvs {

constexpr int kFeat = 128;     // descriptor length
constexpr int kQueries = 128;  // queries per block, one per thread
constexpr int kRefTile = 32;   // reference rows per shared-memory tile
constexpr float kBig = 3.0e38f;

struct Top2 {
  float d1, d2;
  int i1;
};

// One past the last true entry of mask[0, n). Every thread of a block of
// kThreads threads calls it; the result is the same in all of them.
template <int kThreads>
__device__ __forceinline__ int live_bound(const unsigned char* __restrict__ mask,
                                          int n) {
  __shared__ int warp_max[kThreads / 32];
  int b = 0;
  for (int i = threadIdx.x; i < n; i += kThreads)
    if (mask[i]) b = i + 1;  // i ascends per thread: the last hit wins
  b = __reduce_max_sync(0xffffffffu, b);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = b;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) r = max(r, warp_max[k]);
  __syncthreads();  // warp_max may be written again by a later call
  return r;
}

// The query row q of qry into registers (zeros when the thread is not live).
__device__ __forceinline__ void load_query(const float* __restrict__ qry,
                                           int q, bool live,
                                           float (&qv)[kFeat]) {
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
}

// Smallest and second-smallest L1 distance from the thread's query to the
// rows of ref[0, nr) whose rmask is true, and the index of the nearest.
// Rows are visited in ascending order with a strict `<`, so the lowest index
// wins ties and a tie at d1 gives d2 = d1. Every thread of the block calls
// it with the same ref, rmask and nr.
__device__ __forceinline__ Top2 l1_top2(const float (&qv)[kFeat],
                                        const float* __restrict__ ref,
                                        const unsigned char* __restrict__ rmask,
                                        int nr) {
  __shared__ __align__(16) float tile[kRefTile][kFeat];
  __shared__ unsigned char tile_ok[kRefTile];
  Top2 t{kBig, kBig, 0};
  for (int j0 = 0; j0 < nr; j0 += kRefTile) {
    __syncthreads();  // previous tile fully consumed
    for (int e = threadIdx.x; e < kRefTile * kFeat / 4; e += blockDim.x) {
      const int row = e / (kFeat / 4);
      const int col = e - row * (kFeat / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + row < nr)
        v = reinterpret_cast<const float4*>(ref +
                                            (long long)(j0 + row) * kFeat)[col];
      reinterpret_cast<float4*>(&tile[row][0])[col] = v;
    }
    if (threadIdx.x < kRefTile)
      tile_ok[threadIdx.x] =
          (j0 + (int)threadIdx.x < nr) && rmask[j0 + threadIdx.x];
    __syncthreads();
    const int jn = min(kRefTile, nr - j0);
    for (int jj = 0; jj < jn; ++jj) {
      if (!tile_ok[jj]) continue;  // the same row for every thread: uniform
      float d = 0.f;
#pragma unroll
      for (int f = 0; f < kFeat; ++f) d += fabsf(qv[f] - tile[jj][f]);
      if (d < t.d1) {
        t.d2 = t.d1;
        t.d1 = d;
        t.i1 = j0 + jj;
      } else if (d < t.d2) {
        t.d2 = d;
      }
    }
  }
  return t;
}

}  // namespace cvs
