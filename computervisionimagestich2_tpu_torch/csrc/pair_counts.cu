// B5: Lowe-ratio match counts of every listed image pair, both directions.
//
// Replaces computervisionimagestich2_tpu/ops/pallas_distance.py::
// pair_match_counts_pallas (_pair_counts_kernel). Contract: the per-pair
// scan of models/registration.py::all_pairs_match_counts on the exact-L1
// path. For pair p = (i, j), out[p, 0] counts the valid descriptors of
// image j (queries) whose nearest / second-nearest L1 distance over image
// i's valid descriptors (references) is below `ratio` (the reference's
// getImgPair(i, j) size), and out[p, 1] the same with the roles swapped.
//
// What bounds it on the H100: arithmetic, as in B4: per pair nq * nr * 128
// |a - b| + add pairs on the FP32 pipes, once for both directions; the
// descriptors are read from L2 and the partials are two floats per row and
// tile. The TPU kernel kept one image's whole reference block in VMEM
// (hence its cap <= 12288 limit) and carried a running per-reference top-2
// across its sequential grid. Hopper blocks run in no order, so the design
// is B4's, over many pairs at once:
// - One block plans a chunk of pairs: the live bound of every image (one
//   past its last valid row, read from the masks on the device, so the
//   host never synchronises and dead capacity costs nothing) and the
//   running count of live 64 x 64 tiles before each pair.
// - A persistent grid of about two blocks per SM walks the flat list of
//   live (pair, query tile, reference tile) triples, finding each tile's
//   pair by bisection of the running counts. Each tile is B4's tile pass
//   (l1_tile.cuh: 256 threads, 4 x 4 accumulators, staged features), so
//   one pass serves both directions and every distance has B4's bits. A
//   count needs no index, so the partials are (d1, d2) only.
// - A merge kernel, one thread per (pair, side, row), folds the row's
//   partials over the other side's live tiles with B4's strict `<` (the
//   two smallest of a multiset do not depend on the order; a minimum that
//   occurs twice gives d2 = d1), applies d2 < BIG && d1 / d2 < ratio (IEEE
//   division), and counts with __ballot_sync / __popc and one integer
//   atomicAdd per block: integer addition is order-free, so two runs give
//   the same counts. Blocks past an image's live bound exit at once.
// - The partials take cap^2 / 4 bytes per pair, so the caller hands over
//   scratch for `chunk` pairs and the launcher walks the pairs in chunks of
//   that size, three launches each, reusing the scratch in stream order.
#include "api.h"
#include "l1_tile.cuh"

namespace {

using namespace cvs;

constexpr int kCountThreads = 256;
constexpr int kPlanThreads = 1024;

// live[m]: one past the last valid row of image m, for every image (the
// whole block); tile_start[s], s in [0, n_chunk]: the live tiles of the
// chunk's pairs before its s-th (a scan by the first warp). One block.
__global__ void __launch_bounds__(kPlanThreads)
pair_plan_kernel(const unsigned char* __restrict__ valid, int n_images,
                 int cap, const int* __restrict__ pairs, int n_chunk,
                 int* __restrict__ live, int* __restrict__ tile_start) {
  for (int m = 0; m < n_images; ++m) {
    const int b = live_bound<kPlanThreads>(valid + (long long)m * cap, cap);
    if (threadIdx.x == 0) live[m] = b;
  }
  __syncthreads();  // live[] is read back below
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int carry = 0;
  for (int s0 = 0; s0 < n_chunk; s0 += 32) {
    const int s = s0 + lane;
    int tiles = 0;
    if (s < n_chunk) {
      const int n_rt = (live[pairs[2 * s]] + kTile - 1) / kTile;
      const int n_qt = (live[pairs[2 * s + 1]] + kTile - 1) / kTile;
      tiles = n_qt * n_rt;
    }
    int incl = tiles;  // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (s < n_chunk) tile_start[s] = carry + incl - tiles;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) tile_start[n_chunk] = carry;
}

// Partials of the chunk's s-th pair (i, j), queries = image j, references =
// image i, at part + s * 4 * n_t * cap with n_t = ceil(cap / 64):
// q_d1, q_d2 [n_t, cap] (query row over reference tile rt, at rt * cap + q),
// then r_d1, r_d2 [n_t, cap] (reference row over query tile qt). Only the
// live tiles are written.
__global__ void __launch_bounds__(kTileThreads, 2)
pair_tile_kernel(const float* __restrict__ desc,
                 const unsigned char* __restrict__ valid, int cap,
                 const int* __restrict__ pairs, int n_chunk,
                 const int* __restrict__ live,
                 const int* __restrict__ tile_start,
                 float* __restrict__ part) {
  __shared__ TileSmem sm;
  const int tid = threadIdx.x;
  const long long plane = (long long)((cap + kTile - 1) / kTile) * cap;
  const int total = tile_start[n_chunk];
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int s = 0, hi = n_chunk;  // the last s with tile_start[s] <= t
    while (hi - s > 1) {
      const int mid = (s + hi) >> 1;
      if (tile_start[mid] <= t) s = mid; else hi = mid;
    }
    const int img_i = pairs[2 * s];
    const int img_j = pairs[2 * s + 1];
    const int n_rt = (live[img_i] + kTile - 1) / kTile;
    const int local = t - tile_start[s];
    const int qt = local / n_rt;
    const int rt = local - qt * n_rt;
    const int q0 = qt * kTile;
    const int r0 = rt * kTile;
    l1_tile_distances(desc + (long long)img_j * cap * kFeat,
                      desc + (long long)img_i * cap * kFeat,
                      valid + (long long)img_j * cap,
                      valid + (long long)img_i * cap, cap, cap, q0, r0, sm);
    float* slot = part + 4 * plane * s;
    if (tid < kTile) {  // query row tid over the tile's references
      const int q = q0 + tid;
      const Top2 p = tile_scan(sm.stage + tid * kDistPitch, 1, sm.r_ok, r0);
      if (q < cap) {
        const long long k = (long long)rt * cap + q;
        slot[k] = p.d1;
        slot[plane + k] = p.d2;
      }
    } else if (tid < 2 * kTile) {  // reference column over the queries
      const int j = tid - kTile;
      const int r = r0 + j;
      const Top2 p = tile_scan(sm.stage + j, kDistPitch, sm.q_ok, q0);
      if (r < cap) {
        const long long k = (long long)qt * cap + r;
        slot[2 * plane + k] = p.d1;
        slot[3 * plane + k] = p.d2;
      }
    }
  }
}

// Block b serves rows [rb * 256, rb * 256 + 256) of one side of the chunk's
// s-th pair: b = (s * 2 + side) * row_blocks + rb. Side 0 is the query
// image j (counted into out[2 s]), side 1 the reference image i (out[2 s +
// 1]).
__global__ void __launch_bounds__(kCountThreads)
pair_count_kernel(const unsigned char* __restrict__ valid, int cap,
                  const int* __restrict__ pairs, int row_blocks,
                  const int* __restrict__ live,
                  const float* __restrict__ part, float ratio,
                  int* __restrict__ out) {
  __shared__ int warp_n[kCountThreads / 32];
  const int rb = blockIdx.x % row_blocks;
  const int side = (blockIdx.x / row_blocks) & 1;
  const int s = blockIdx.x / (2 * row_blocks);
  const int own = pairs[2 * s + (side == 0 ? 1 : 0)];
  const int other = pairs[2 * s + (side == 0 ? 0 : 1)];
  if (rb * kCountThreads >= live[own]) return;  // uniform: no valid row here
  const int row = rb * kCountThreads + threadIdx.x;
  const bool ok_row = row < cap && valid[(long long)own * cap + row];
  const int n_tiles = (live[other] + kTile - 1) / kTile;
  const long long plane = (long long)((cap + kTile - 1) / kTile) * cap;
  const float* p1 = part + (4 * s + 2 * side) * plane;
  const float* p2 = p1 + plane;
  float d1 = kBig, d2 = kBig;
  for (int t = 0; ok_row && t < n_tiles; ++t) {
    const long long k = (long long)t * cap + row;
    merge_top2(d1, d2, p1[k], p2[k]);
  }
  const bool hit = ok_row && d2 < kBig && (d1 / d2) < ratio;
  const unsigned hits = __ballot_sync(0xffffffffu, hit);
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = __popc(hits);
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
#pragma unroll
    for (int k = 0; k < kCountThreads / 32; ++k) n += warp_n[k];
    if (n) atomicAdd(&out[2 * s + side], n);
  }
}

}  // namespace

extern "C" cudaError_t cvs_pair_match_counts(
    const float* desc, const unsigned char* valid, int n_images, int cap,
    const int* pairs, int n_pairs, float ratio, int chunk, int* live,
    int* tile_start, float* part, int* out, cudaStream_t stream) {
  if (n_pairs == 0 || cap == 0) return cudaSuccess;
  if (chunk < 1) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long n_t = (cap + kTile - 1) / kTile;
  const int row_blocks = (cap + kCountThreads - 1) / kCountThreads;
  for (int p0 = 0; p0 < n_pairs; p0 += chunk) {
    const int n_chunk = n_pairs - p0 < chunk ? n_pairs - p0 : chunk;
    const int* cp = pairs + 2 * p0;
    pair_plan_kernel<<<1, kPlanThreads, 0, stream>>>(valid, n_images, cap, cp,
                                                     n_chunk, live,
                                                     tile_start);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long most = n_chunk * n_t * n_t;  // tiles if every row is live
    const long long grid = most < 2LL * sms ? most : 2LL * sms;
    pair_tile_kernel<<<(unsigned)grid, kTileThreads, 0, stream>>>(
        desc, valid, cap, cp, n_chunk, live, tile_start, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    pair_count_kernel<<<(unsigned)(n_chunk * 2 * row_blocks), kCountThreads,
                        0, stream>>>(valid, cap, cp, row_blocks, live, part,
                                     ratio, out + 2 * p0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
