// The 64 x 64 tile pass shared by kernels B4 and B7 (l1_2nn.cu) and B5
// (pair_counts.cu): the L1 distances of 64 query rows to 64 reference rows
// and the top-2 scan of one row or column of that tile.
//
// Layout: a block of kTileThreads = 256 threads, 16 x 16, each with a 4 x 4
// micro-tile of accumulators, so every thread runs 16 independent sums and
// every feature read from shared memory feeds 4 of them. Features are staged
// 32 at a time, transposed, in shared memory, with the next chunk prefetched
// into registers while this one is summed. Every distance is summed over
// f = 0..127 in ascending order into one float from 0, and |a - b| = |b - a|
// in IEEE arithmetic, so B4, B5 and B7 see the same bits whichever side is
// called the query.
#pragma once
#include "l1.cuh"

namespace cvs {

constexpr int kTile = 64;           // queries and references per tile
constexpr int kChunk = 32;          // features staged per step
constexpr int kTileThreads = 256;   // 16 x 16 threads, 4 x 4 distances each
constexpr int kStage = kChunk * kTile;  // floats of one staged side
constexpr int kDistPitch = kTile + 1;   // conflict-free row and column scans
static_assert(kTile * kDistPitch <= 4 * kStage, "distance tile must fit");

// Shared memory of one tile pass. stage: [buffer][query | reference]
// [feature][row]; after the feature loop the same bytes hold the tile's
// distances, [query][kDistPitch]. q_ok, r_ok: the masks of the tile's rows.
struct __align__(16) TileSmem {
  float stage[4 * kStage];
  unsigned char q_ok[kTile];
  unsigned char r_ok[kTile];
};

// This thread's share of one chunk: rows [row0, row0 + 64) of src [n, 128],
// features [c * 32, c * 32 + 32), as two float4 (zeros past n). Lane l of a
// warp takes row l (mod 64), so the transposed stores below hit 32 banks.
__device__ __forceinline__ void load_chunk(const float* __restrict__ src,
                                           int n, int row0, int c,
                                           float4 (&v)[2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = threadIdx.x + s * kTileThreads;
    const int row = e & (kTile - 1);
    const int col4 = e >> 6;  // 0..7
    v[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < n)
      v[s] = reinterpret_cast<const float4*>(
          src + (long long)(row0 + row) * kFeat + c * kChunk)[col4];
  }
}

// Store a loaded share transposed: dst[f][row], f in [0, 32).
__device__ __forceinline__ void store_chunk(float* __restrict__ dst,
                                            const float4 (&v)[2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = threadIdx.x + s * kTileThreads;
    const int row = e & (kTile - 1);
    const int f = (e >> 6) * 4;
    dst[(f + 0) * kTile + row] = v[s].x;
    dst[(f + 1) * kTile + row] = v[s].y;
    dst[(f + 2) * kTile + row] = v[s].z;
    dst[(f + 3) * kTile + row] = v[s].w;
  }
}

// The distances of queries [q0, q0 + 64) of qry [nb, 128] to references
// [r0, r0 + 64) of ref [na, 128], into sm.stage as dist[query][kDistPitch],
// and the masks of those rows into sm.q_ok / sm.r_ok (false past nb / na).
// Every thread of the block calls it; it begins and ends with a block
// barrier, so the caller may scan the tile right after and call again after
// the scans.
__device__ __forceinline__ void l1_tile_distances(
    const float* __restrict__ qry, const float* __restrict__ ref,
    const unsigned char* __restrict__ qry_valid,
    const unsigned char* __restrict__ ref_valid, int nb, int na, int q0,
    int r0, TileSmem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // references tx * 4 .. tx * 4 + 3 of the tile
  const int ty = tid >> 4;  // queries ty * 4 .. ty * 4 + 3
  __syncthreads();  // the previous tile's scans are done with `stage`
  if (tid < kTile) {
    sm.q_ok[tid] = q0 + tid < nb && qry_valid[q0 + tid];
  } else if (tid < 2 * kTile) {
    const int j = tid - kTile;
    sm.r_ok[j] = r0 + j < na && ref_valid[r0 + j];
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float4 gq[2], gr[2];
  load_chunk(qry, nb, q0, 0, gq);
  load_chunk(ref, na, r0, 0, gr);
#pragma unroll 1
  for (int c = 0; c < kFeat / kChunk; ++c) {
    float* sq = sm.stage + (c & 1) * 2 * kStage;
    float* sr = sq + kStage;
    // buffer c & 1 was last read in step c - 2, before step c - 1's sync
    store_chunk(sq, gq);
    store_chunk(sr, gr);
    __syncthreads();
    if (c + 1 < kFeat / kChunk) {
      load_chunk(qry, nb, q0, c + 1, gq);
      load_chunk(ref, na, r0, c + 1, gr);
    }
#pragma unroll
    for (int f = 0; f < kChunk; ++f) {
      const float4 a = *reinterpret_cast<const float4*>(sq + f * kTile +
                                                        ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(sr + f * kTile +
                                                        tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += fabsf(av[i] - bv[j]);
    }
  }
  __syncthreads();  // every thread is done reading the staged features
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sm.stage[(ty * 4 + i) * kDistPitch + tx * 4 + j] = acc[i][j];
  __syncthreads();
}

// Top-2 of the 64 distances d[0], d[step], d[2 step], ... whose ok entry is
// set, in ascending order with a strict `<` (the lowest index wins, a tie
// at d1 gives d2 = d1); i1 = base + the winner's position.
__device__ __forceinline__ Top2 tile_scan(const float* __restrict__ d,
                                          int step,
                                          const unsigned char* __restrict__ ok,
                                          int base) {
  Top2 p{kBig, kBig, 0};
  for (int k = 0; k < kTile; ++k) {
    if (!ok[k]) continue;
    const float v = d[k * step];
    if (v < p.d1) {
      p.d2 = p.d1;
      p.d1 = v;
      p.i1 = base + k;
    } else if (v < p.d2) {
      p.d2 = v;
    }
  }
  return p;
}

// Fold a later tile's partial (b1, b2) into the running (d1, d2): the two
// smallest of the union, d2 = d1 when the minimum occurs twice. True when
// b1 is the new strict minimum.
__device__ __forceinline__ bool merge_top2(float& d1, float& d2, float b1,
                                           float b2) {
  if (b1 < d1) {
    d2 = fminf(d1, b2);
    d1 = b1;
    return true;
  }
  d2 = fminf(d2, b1);
  return false;
}

// Streaming multiprocessors of the current device, read once per device.
inline cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  *sms = dev < 64 ? cached[dev] : 0;
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < 64) cached[dev] = *sms;
  }
  return cudaSuccess;
}

}  // namespace cvs
