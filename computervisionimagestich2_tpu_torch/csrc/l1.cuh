// What every L1 kernel of the port shares: the descriptor length, BIG, the
// top-2 record and the live bound of a mask. The distances themselves come
// from the 64 x 64 tile pass of l1_tile.cuh, which B4, B5 and B7 all run:
// it sums |q - r| over the 128 features in ascending order into one float
// from 0, so they all give the same distance bits, an image pair's
// match-graph count (B5) equals the count of one B4 launch on it, and B7
// equals B4's query side. Masks are honoured row by row: a row whose mask is
// false never wins, and the tiles past the last true mask entry are never
// visited.
#pragma once
#include <cuda_runtime.h>

namespace cvs {

constexpr int kFeat = 128;  // descriptor length
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

}  // namespace cvs
