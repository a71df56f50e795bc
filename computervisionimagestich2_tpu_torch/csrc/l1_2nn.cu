// B4 and B7: exact L1 two-nearest-neighbour search over 128-d SIFT
// descriptors.
//
// B4 replaces computervisionimagestich2_tpu/ops/pallas_distance.py::
// two_nearest_l1_bidir_pallas (_bidir_kernel): from ONE distance pass, for
// every valid query the smallest and second-smallest L1 distance to the
// valid references and the index of the nearest, and the same for every
// valid reference over the valid queries (contract: ops/distance.py::
// two_nearest_bidir). Invalid rows get d1 = d2 = BIG and i1 = 0. B7
// replaces two_nearest_l1_pallas (_kernel), one direction (contract:
// ops/distance.py::two_nearest), and keeps the loop of l1.cuh.
//
// What bounds B4 on the H100: arithmetic. Each live query x reference
// distance is 128 subtractions and 128 adds of an absolute value on the
// FP32 pipes (no tensor-core form of L1 exists); device memory traffic is
// only the two descriptor sets and the small per-tile partials. The design
// against that bound:
// - A block owns a 64-query x 64-reference tile: 256 threads, each with a
//   4 x 4 micro-tile of accumulators, so every thread runs 16 independent
//   sums and every feature read from shared memory feeds 4 of them.
//   Features are staged 32 at a time, transposed, in shared memory, with
//   the next chunk prefetched into registers while this one is summed.
// - Each tile yields both directions: its 64 x 64 distances go to shared
//   memory, one thread scans each query row and one each reference column
//   in ascending index with a strict `<`, and each writes a partial top-2
//   for its tile. A second small kernel merges the partials of each row in
//   ascending tile order, also with a strict `<`: the lowest index wins,
//   a tie at d1 gives d2 = d1, exactly as one sequential pass would.
// - The grid is persistent: about two blocks per SM walk the live tiles,
//   whose count follows from the live bounds of the masks, read on the
//   device (live_bound), so the host never synchronises and dead capacity
//   costs nothing. The TPU kernel carried the per-reference top-2 across
//   its sequential grid in VMEM scratch; Hopper blocks run in no order,
//   hence the partials and the merge. No float atomics: two runs give the
//   same bits.
// - Every distance is summed over f = 0..127 in ascending order into one
//   float from 0, as l1.cuh does, and |a - b| = |b - a| in IEEE
//   arithmetic, so both directions and B5's counts see the same bits.
#include "api.h"
#include "l1.cuh"

namespace {

using namespace cvs;

// ------------------------------------------------------------------ B7
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
  const int nr = live_bound<kQueries>(ref_valid, na);
  float qv[kFeat];
  load_query(qry, q, live, qv);
  const Top2 t = l1_top2(qv, ref, ref_valid, nr);
  if (q < nb) {
    d1_out[q] = live ? t.d1 : kBig;
    d2_out[q] = live ? t.d2 : kBig;
    i1_out[q] = live ? t.i1 : 0;
  }
}

// ------------------------------------------------------------------ B4
constexpr int kTile = 64;           // queries and references per tile
constexpr int kChunk = 32;          // features staged per step
constexpr int kTileThreads = 256;   // 16 x 16 threads, 4 x 4 distances each
constexpr int kMergeThreads = 256;
constexpr int kStage = kChunk * kTile;  // floats of one staged side
constexpr int kDistPitch = kTile + 1;   // conflict-free row and column scans
static_assert(kTile * kDistPitch <= 4 * kStage, "distance tile must fit");

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

// Partial top-2s: part_q_* [n_rt_cap, nb] (query row over reference tile
// rt, at rt * nb + q) and part_r_* [n_qt_cap, na] (reference row over query
// tile qt, at qt * na + r). Only the live tiles are written.
__global__ void __launch_bounds__(kTileThreads, 2)
l1_bidir_tile_kernel(const float* __restrict__ qry,
                     const float* __restrict__ ref,
                     const unsigned char* __restrict__ qry_valid,
                     const unsigned char* __restrict__ ref_valid, int nb,
                     int na, float* __restrict__ part_q_d1,
                     float* __restrict__ part_q_d2,
                     int* __restrict__ part_q_i1,
                     float* __restrict__ part_r_d1,
                     float* __restrict__ part_r_d2,
                     int* __restrict__ part_r_i1) {
  // [buffer][query | reference][feature][row]; after the feature loop the
  // same bytes hold the tile's distances, [query][kDistPitch]
  __shared__ __align__(16) float stage[4 * kStage];
  __shared__ unsigned char q_ok[kTile];
  __shared__ unsigned char r_ok[kTile];
  const int n_qt = (live_bound<kTileThreads>(qry_valid, nb) + kTile - 1) /
                   kTile;
  const int n_rt = (live_bound<kTileThreads>(ref_valid, na) + kTile - 1) /
                   kTile;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // references tx * 4 .. tx * 4 + 3 of the tile
  const int ty = tid >> 4;  // queries ty * 4 .. ty * 4 + 3
  for (int t = blockIdx.x; t < n_qt * n_rt; t += gridDim.x) {
    const int qt = t / n_rt;
    const int rt = t - qt * n_rt;
    const int q0 = qt * kTile;
    const int r0 = rt * kTile;
    __syncthreads();  // the previous tile's scans are done with `stage`
    if (tid < kTile) {
      q_ok[tid] = q0 + tid < nb && qry_valid[q0 + tid];
    } else if (tid < 2 * kTile) {
      const int j = tid - kTile;
      r_ok[j] = r0 + j < na && ref_valid[r0 + j];
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
      float* sq = stage + (c & 1) * 2 * kStage;
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
    float* dist = stage;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dist[(ty * 4 + i) * kDistPitch + tx * 4 + j] = acc[i][j];
    __syncthreads();
    if (tid < kTile) {  // query row tid over the tile's references
      const int q = q0 + tid;
      Top2 p{kBig, kBig, 0};
      for (int j = 0; j < kTile; ++j) {
        if (!r_ok[j]) continue;
        const float d = dist[tid * kDistPitch + j];
        if (d < p.d1) {
          p.d2 = p.d1;
          p.d1 = d;
          p.i1 = r0 + j;
        } else if (d < p.d2) {
          p.d2 = d;
        }
      }
      if (q < nb) {
        const long long k = (long long)rt * nb + q;
        part_q_d1[k] = p.d1;
        part_q_d2[k] = p.d2;
        part_q_i1[k] = p.i1;
      }
    } else if (tid < 2 * kTile) {  // reference column over the queries
      const int j = tid - kTile;
      const int r = r0 + j;
      Top2 p{kBig, kBig, 0};
      for (int i = 0; i < kTile; ++i) {
        if (!q_ok[i]) continue;
        const float d = dist[i * kDistPitch + j];
        if (d < p.d1) {
          p.d2 = p.d1;
          p.d1 = d;
          p.i1 = q0 + i;
        } else if (d < p.d2) {
          p.d2 = d;
        }
      }
      if (r < na) {
        const long long k = (long long)qt * na + r;
        part_r_d1[k] = p.d1;
        part_r_d2[k] = p.d2;
        part_r_i1[k] = p.i1;
      }
    }
  }
}

// One thread per row: blocks [0, q_blocks) take the query rows, the rest
// the reference rows. A valid row merges its partials over the other side's
// live tiles in ascending tile order; an invalid row gets BIG.
__global__ void __launch_bounds__(kMergeThreads)
l1_bidir_merge_kernel(const unsigned char* __restrict__ qry_valid,
                      const unsigned char* __restrict__ ref_valid, int nb,
                      int na, int q_blocks,
                      const float* __restrict__ part_q_d1,
                      const float* __restrict__ part_q_d2,
                      const int* __restrict__ part_q_i1,
                      const float* __restrict__ part_r_d1,
                      const float* __restrict__ part_r_d2,
                      const int* __restrict__ part_r_i1,
                      float* __restrict__ d1q, float* __restrict__ d2q,
                      int* __restrict__ i1q, float* __restrict__ d1r,
                      float* __restrict__ d2r, int* __restrict__ i1r) {
  const bool qside = (int)blockIdx.x < q_blocks;
  const int row = ((int)blockIdx.x - (qside ? 0 : q_blocks)) * kMergeThreads +
                  threadIdx.x;
  const int n = qside ? nb : na;
  const unsigned char* own = qside ? qry_valid : ref_valid;
  const bool live = row < n && own[row];
  Top2 a{kBig, kBig, 0};
  if (__syncthreads_or(live)) {  // uniform across the block
    const int n_tiles =
        (live_bound<kMergeThreads>(qside ? ref_valid : qry_valid,
                                   qside ? na : nb) + kTile - 1) / kTile;
    const float* p1 = qside ? part_q_d1 : part_r_d1;
    const float* p2 = qside ? part_q_d2 : part_r_d2;
    const int* pi = qside ? part_q_i1 : part_r_i1;
    for (int t = 0; live && t < n_tiles; ++t) {
      const long long k = (long long)t * n + row;
      const float b1 = p1[k];
      if (b1 < a.d1) {
        a.d2 = fminf(a.d1, p2[k]);
        a.d1 = b1;
        a.i1 = pi[k];
      } else {
        a.d2 = fminf(a.d2, b1);
      }
    }
  }
  if (row < n) {
    (qside ? d1q : d1r)[row] = live ? a.d1 : kBig;
    (qside ? d2q : d2r)[row] = live ? a.d2 : kBig;
    (qside ? i1q : i1r)[row] = live ? a.i1 : 0;
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

extern "C" cudaError_t cvs_l1_two_nearest_bidir(
    const float* qry, const float* ref, const unsigned char* qry_valid,
    const unsigned char* ref_valid, int nb, int na, float* part_d,
    int* part_i, float* d1q, float* d2q, int* i1q, float* d1r, float* d2r,
    int* i1r, cudaStream_t stream) {
  if (nb == 0 && na == 0) return cudaSuccess;
  const long long n_qt = (nb + kTile - 1) / kTile;
  const long long n_rt = (na + kTile - 1) / kTile;
  const long long len_q = n_rt * nb;  // partials of the query rows
  const long long len_r = n_qt * na;  // partials of the reference rows
  float* part_q_d1 = part_d;
  float* part_q_d2 = part_d + len_q;
  float* part_r_d1 = part_d + 2 * len_q;
  float* part_r_d2 = part_d + 2 * len_q + len_r;
  int* part_q_i1 = part_i;
  int* part_r_i1 = part_i + len_q;
  if (n_qt * n_rt > 0) {
    static int sm_count[64] = {};  // per device, read once
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 64) sms = sm_count[dev];
    if (sms == 0) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      if (dev < 64) sm_count[dev] = sms;
    }
    const long long grid = n_qt * n_rt < 2LL * sms ? n_qt * n_rt : 2LL * sms;
    l1_bidir_tile_kernel<<<(unsigned)grid, kTileThreads, 0, stream>>>(
        qry, ref, qry_valid, ref_valid, nb, na, part_q_d1, part_q_d2,
        part_q_i1, part_r_d1, part_r_d2, part_r_i1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int q_blocks = (nb + kMergeThreads - 1) / kMergeThreads;
  const int r_blocks = (na + kMergeThreads - 1) / kMergeThreads;
  l1_bidir_merge_kernel<<<q_blocks + r_blocks, kMergeThreads, 0, stream>>>(
      qry_valid, ref_valid, nb, na, q_blocks, part_q_d1, part_q_d2, part_q_i1,
      part_r_d1, part_r_d2, part_r_i1, d1q, d2q, i1q, d1r, d2r, i1r);
  return cudaGetLastError();
}
