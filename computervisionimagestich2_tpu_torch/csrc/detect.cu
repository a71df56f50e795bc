// B1: fused SIFT detection: strict 26-neighbour DoG extrema, compacted into
// the scan-order candidate list.
//
// Replaces computervisionimagestich2_tpu/ops/pallas_detect.py::
// detect_compact_pallas (_detect_kernel and its XLA tail). Contract:
// ops/detect.py::detect_compact_plain, i.e. sift_kernels.compact_mask(
// extrema_mask(dog, peak_thresh), capacity) with the TPU kernel's per-row
// cap: each image row keeps its first kRowCap hits in ascending x. Hits are
// listed in (s, y, x) scan order and truncated at `capacity`; n_total is the
// uncapped hit count.
//
// What bounds it on the H100: device memory. Each DoG value is read by the
// 27 stencils around it (3 levels x 3 rows x 3 columns), served from L1/L2,
// and the output is a few thousand coordinates: one pass over the [S+2, H,
// W] stack at HBM bandwidth is the floor. The TPU kernel's DMA ring, lane
// rolls and one-hot extraction loop do not carry over. Simple design, two
// launches:
//   1. one warp per (output level s, image row y) walks x in 32-wide chunks,
//      in order. Each lane tests one pixel; the chunk's hits are compacted
//      with __ballot_sync + __popc into ascending-x positions of the row list
//      [S*H, kRowCap] (no atomics, so the order is the same every run), and
//      the row's uncapped count is written beside it;
//   2. one block scans the capped row counts in (s, y) order, scatters each
//      row's list into coords / valid truncated at `capacity`, and writes
//      n_total, the sum of the uncapped counts.
#include <math_constants.h>

#include "api.h"

namespace {

constexpr int kRowCap = 128;      // hits kept per image row
constexpr int kRowsPerBlock = 4;  // pass 1: one warp per image row
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(32 * kRowsPerBlock)
detect_rows_kernel(const float* __restrict__ dog, int h, int w, float gate,
                   int* __restrict__ row_lists, int* __restrict__ row_counts) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int s = blockIdx.y;  // output level s <-> DoG level s + 1
  if (y >= h) return;        // the whole warp leaves together
  const long long plane = (long long)h * w;
  const int row = s * h + y;
  int n = 0;  // uncapped hits of this row so far
  if (y >= 1 && y <= h - 2) {
    const float* c = dog + (s + 1) * plane + (long long)y * w;
    for (int x0 = 0; x0 < w; x0 += 32) {
      const int x = x0 + lane;
      bool hit = false;
      if (x >= 1 && x <= w - 2) {
        const float v = c[x];
        float nmax = -CUDART_INF_F, nmin = CUDART_INF_F;
#pragma unroll
        for (int dl = -1; dl <= 1; ++dl) {
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy) {
            const float* r = c + dl * plane + dy * w + x;
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
              if (dl == 0 && dy == 0 && dx == 0) continue;
              nmax = fmaxf(nmax, r[dx]);
              nmin = fminf(nmin, r[dx]);
            }
          }
        }
        hit = (v >= gate && v > nmax) || (v <= -gate && v < nmin);
      }
      const unsigned b = __ballot_sync(0xffffffffu, hit);
      const int pos = n + __popc(b & ((1u << lane) - 1u));
      if (hit && pos < kRowCap)
        row_lists[(long long)row * kRowCap + pos] = x;
      n += __popc(b);
    }
  }
  if (lane == 0) row_counts[row] = n;
}

__global__ void __launch_bounds__(kScanThreads)
detect_flatten_kernel(const int* __restrict__ row_lists,
                      const int* __restrict__ row_counts, int n_rows, int h,
                      int capacity, long long* __restrict__ coords,
                      unsigned char* __restrict__ valid,
                      int* __restrict__ n_total) {
  __shared__ int scan[kScanThreads];
  __shared__ int warp_sum[kScanThreads / 32];
  const int t = threadIdx.x;
  // each thread owns a contiguous run of rows, so runs ascend with t
  const int per = (n_rows + kScanThreads - 1) / kScanThreads;
  const int r0 = min(t * per, n_rows);
  const int r1 = min(r0 + per, n_rows);
  int capped = 0, uncapped = 0;
  for (int r = r0; r < r1; ++r) {
    const int c = row_counts[r];
    capped += min(c, kRowCap);
    uncapped += c;
  }
  // inclusive scan of the capped counts over the threads (Hillis-Steele)
  scan[t] = capped;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int add = t >= off ? scan[t - off] : 0;
    __syncthreads();
    scan[t] += add;
    __syncthreads();
  }
  const int kept = min(scan[kScanThreads - 1], capacity);
  for (int k = t; k < capacity; k += kScanThreads) {
    valid[k] = k < kept;
    if (k >= kept) {
      coords[3LL * k] = 0;
      coords[3LL * k + 1] = 0;
      coords[3LL * k + 2] = 0;
    }
  }
  int slot = scan[t] - capped;  // exclusive prefix: this run's first slot
  for (int r = r0; r < r1 && slot < capacity; ++r) {
    const int c = min(row_counts[r], kRowCap);
    const int s = r / h;
    const int y = r - s * h;
    for (int k = 0; k < c && slot < capacity; ++k, ++slot) {
      coords[3LL * slot] = s;
      coords[3LL * slot + 1] = y;
      coords[3LL * slot + 2] = row_lists[(long long)r * kRowCap + k];
    }
  }
  // n_total: fixed-order sum of the uncapped counts
  uncapped = __reduce_add_sync(0xffffffffu, uncapped);
  if ((t & 31) == 0) warp_sum[t >> 5] = uncapped;
  __syncthreads();
  if (t == 0) {
    int total = 0;
    for (int k = 0; k < kScanThreads / 32; ++k) total += warp_sum[k];
    n_total[0] = total;
  }
}

}  // namespace

extern "C" cudaError_t cvs_detect_compact(const float* dog, int s_out, int h,
                                          int w, float gate, int capacity,
                                          int* row_lists, int* row_counts,
                                          long long* coords,
                                          unsigned char* valid, int* n_total,
                                          cudaStream_t stream) {
  const dim3 grid((unsigned)((h + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)s_out);
  detect_rows_kernel<<<grid, 32 * kRowsPerBlock, 0, stream>>>(
      dog, h, w, gate, row_lists, row_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  detect_flatten_kernel<<<1, kScanThreads, 0, stream>>>(
      row_lists, row_counts, s_out * h, h, capacity, coords, valid, n_total);
  return cudaGetLastError();
}
