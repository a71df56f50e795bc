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
// ops/distance.py::two_nearest): the same tile pass with the query rows'
// scans and merge only, in device kernels of its own name, so a profile
// keeps the two apart.
//
// What bounds both on the H100: arithmetic. Each live query x reference
// distance is 128 subtractions and 128 adds of an absolute value on the
// FP32 pipes (no tensor-core form of L1 exists); device memory traffic is
// only the two descriptor sets and the small per-tile partials. The design
// against that bound:
// - A block owns a 64-query x 64-reference tile and computes its distances
//   with the tile pass of l1_tile.cuh (256 threads, 4 x 4 accumulators
//   each, features staged 32 at a time), which B5 runs too.
// - Each tile yields both directions: its 64 x 64 distances go to shared
//   memory, one thread scans each query row and (B4) one each reference
//   column in ascending index with a strict `<`, and each writes a partial
//   top-2 for its tile. A second small kernel merges the partials of each
//   row in ascending tile order, also with a strict `<`: the lowest index
//   wins, a tie at d1 gives d2 = d1, exactly as one sequential pass would.
// - The grid is persistent: about two blocks per SM walk the live tiles,
//   whose count follows from the live bounds of the masks, read on the
//   device (live_bound), so the host never synchronises and dead capacity
//   costs nothing. (B7's first design gave a query to a thread and walked
//   every reference in a block of 128: 12 blocks on 132 SMs at 1,466
//   queries.) The TPU kernel carried the per-reference top-2 across its
//   sequential grid in VMEM scratch; Hopper blocks run in no order, hence
//   the partials and the merge. No float atomics: two runs give the same
//   bits.
// - Every distance is summed over f = 0..127 in ascending order into one
//   float from 0, and |a - b| = |b - a| in IEEE arithmetic, so both
//   directions, B7 and B5's counts see the same bits.
#include "api.h"
#include "l1_tile.cuh"

namespace {

using namespace cvs;

constexpr int kMergeThreads = 256;

// Thread tid < 64 of a tile block: the partial top-2 of query row q0 + tid
// over the tile's references, into the partials at [rt * nb + q].
__device__ __forceinline__ void write_query_partial(
    const TileSmem& sm, int tid, int q0, int r0, int rt, int nb,
    float* __restrict__ part_d1, float* __restrict__ part_d2,
    int* __restrict__ part_i1) {
  const int q = q0 + tid;
  const Top2 p = tile_scan(sm.stage + tid * kDistPitch, 1, sm.r_ok, r0);
  if (q < nb) {
    const long long k = (long long)rt * nb + q;
    part_d1[k] = p.d1;
    part_d2[k] = p.d2;
    part_i1[k] = p.i1;
  }
}

// One thread per row of a merge block: a valid row (`live`) merges its
// partials [t * n + row] over the other side's live tiles in ascending tile
// order; the other rows get BIG, BIG, 0. Every thread of the block calls it.
__device__ __forceinline__ Top2 merge_row(
    bool live, const unsigned char* __restrict__ other_valid, int other_n,
    int n, int row, const float* __restrict__ p1,
    const float* __restrict__ p2, const int* __restrict__ pi) {
  Top2 a{kBig, kBig, 0};
  if (__syncthreads_or(live)) {  // uniform across the block
    const int n_tiles =
        (live_bound<kMergeThreads>(other_valid, other_n) + kTile - 1) / kTile;
    for (int t = 0; live && t < n_tiles; ++t) {
      const long long k = (long long)t * n + row;
      if (merge_top2(a.d1, a.d2, p1[k], p2[k])) a.i1 = pi[k];
    }
  }
  return a;
}

// ------------------------------------------------------------------ B7
// Partial top-2s part_* [n_rt_cap, nb]: query row q over reference tile rt
// at rt * nb + q. Only the live tiles are written.
__global__ void __launch_bounds__(kTileThreads, 2)
l1_one_way_tile_kernel(const float* __restrict__ qry,
                       const float* __restrict__ ref,
                       const unsigned char* __restrict__ qry_valid,
                       const unsigned char* __restrict__ ref_valid, int nb,
                       int na, float* __restrict__ part_d1,
                       float* __restrict__ part_d2,
                       int* __restrict__ part_i1) {
  __shared__ TileSmem sm;
  const int n_qt = (live_bound<kTileThreads>(qry_valid, nb) + kTile - 1) /
                   kTile;
  const int n_rt = (live_bound<kTileThreads>(ref_valid, na) + kTile - 1) /
                   kTile;
  for (int t = blockIdx.x; t < n_qt * n_rt; t += gridDim.x) {
    const int qt = t / n_rt;
    const int rt = t - qt * n_rt;
    l1_tile_distances(qry, ref, qry_valid, ref_valid, nb, na, qt * kTile,
                      rt * kTile, sm);
    if (threadIdx.x < kTile)
      write_query_partial(sm, threadIdx.x, qt * kTile, rt * kTile, rt, nb,
                          part_d1, part_d2, part_i1);
  }
}

__global__ void __launch_bounds__(kMergeThreads)
l1_one_way_merge_kernel(const unsigned char* __restrict__ qry_valid,
                        const unsigned char* __restrict__ ref_valid, int nb,
                        int na, const float* __restrict__ part_d1,
                        const float* __restrict__ part_d2,
                        const int* __restrict__ part_i1,
                        float* __restrict__ d1, float* __restrict__ d2,
                        int* __restrict__ i1) {
  const int row = blockIdx.x * kMergeThreads + threadIdx.x;
  const bool live = row < nb && qry_valid[row];
  const Top2 a = merge_row(live, ref_valid, na, nb, row, part_d1, part_d2,
                           part_i1);
  if (row < nb) {
    d1[row] = a.d1;
    d2[row] = a.d2;
    i1[row] = a.i1;
  }
}

// ------------------------------------------------------------------ B4
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
  __shared__ TileSmem sm;
  const int n_qt = (live_bound<kTileThreads>(qry_valid, nb) + kTile - 1) /
                   kTile;
  const int n_rt = (live_bound<kTileThreads>(ref_valid, na) + kTile - 1) /
                   kTile;
  const int tid = threadIdx.x;
  for (int t = blockIdx.x; t < n_qt * n_rt; t += gridDim.x) {
    const int qt = t / n_rt;
    const int rt = t - qt * n_rt;
    const int q0 = qt * kTile;
    const int r0 = rt * kTile;
    l1_tile_distances(qry, ref, qry_valid, ref_valid, nb, na, q0, r0, sm);
    if (tid < kTile) {  // query row tid over the tile's references
      write_query_partial(sm, tid, q0, r0, rt, nb, part_q_d1, part_q_d2,
                          part_q_i1);
    } else if (tid < 2 * kTile) {  // reference column over the queries
      const int j = tid - kTile;
      const int r = r0 + j;
      const Top2 p = tile_scan(sm.stage + j, kDistPitch, sm.q_ok, q0);
      if (r < na) {
        const long long k = (long long)qt * na + r;
        part_r_d1[k] = p.d1;
        part_r_d2[k] = p.d2;
        part_r_i1[k] = p.i1;
      }
    }
  }
}

// One thread per row (merge_row): blocks [0, q_blocks) take the query rows,
// the rest the reference rows.
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
  const Top2 a = merge_row(live, qside ? ref_valid : qry_valid,
                           qside ? na : nb, n, row,
                           qside ? part_q_d1 : part_r_d1,
                           qside ? part_q_d2 : part_r_d2,
                           qside ? part_q_i1 : part_r_i1);
  if (row < n) {
    (qside ? d1q : d1r)[row] = a.d1;
    (qside ? d2q : d2r)[row] = a.d2;
    (qside ? i1q : i1r)[row] = a.i1;
  }
}

}  // namespace

// The persistent grid of a tile pass over n_tiles tiles: two blocks per SM.
static cudaError_t tile_grid(long long n_tiles, unsigned* grid) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  *grid = (unsigned)(n_tiles < 2LL * sms ? n_tiles : 2LL * sms);
  return err;
}

extern "C" cudaError_t cvs_l1_two_nearest(const float* qry, const float* ref,
                                          const unsigned char* qry_valid,
                                          const unsigned char* ref_valid,
                                          int nb, int na, float* part_d,
                                          int* part_i, float* d1, float* d2,
                                          int* i1, cudaStream_t stream) {
  if (nb == 0) return cudaSuccess;
  const long long n_qt = (nb + kTile - 1) / kTile;
  const long long n_rt = (na + kTile - 1) / kTile;
  float* part_d1 = part_d;
  float* part_d2 = part_d + n_rt * nb;
  if (n_rt > 0) {
    unsigned grid = 0;
    cudaError_t err = tile_grid(n_qt * n_rt, &grid);
    if (err != cudaSuccess) return err;
    l1_one_way_tile_kernel<<<grid, kTileThreads, 0, stream>>>(
        qry, ref, qry_valid, ref_valid, nb, na, part_d1, part_d2, part_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  l1_one_way_merge_kernel<<<(nb + kMergeThreads - 1) / kMergeThreads,
                            kMergeThreads, 0, stream>>>(
      qry_valid, ref_valid, nb, na, part_d1, part_d2, part_i, d1, d2, i1);
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
    unsigned grid = 0;
    cudaError_t err = tile_grid(n_qt * n_rt, &grid);
    if (err != cudaSuccess) return err;
    l1_bidir_tile_kernel<<<grid, kTileThreads, 0, stream>>>(
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
