// B2 and B3: the per-keypoint SIFT walks over one gradient level.
//
// B2 replaces computervisionimagestich2_tpu/ops/pallas_sift.py::
// orientation_hist_pallas (_ori_kernel): the raw 36-bin gradient-angle
// histogram of each live keypoint (vl/sift.c:904-1036). Window
// |dx|, |dy| <= wr = max(floor(4.5 sigma), 1) with r^2 < wr^2 + 0.6, inside
// the image; weight modulus * exp(-r^2 / (2 (1.5 sigma)^2)); linear
// (circular) split between the two nearest bins. Smoothing and peak
// picking stay in PyTorch (ops/sift_kernels.py::orientation_peaks).
//
// B3 replaces pallas_sift.py::descriptors_pallas (_desc_kernel): the
// 4x4x8 SIFT descriptor of each live keypoint x angle
// (vl/sift.c:1268-1438), window radius floor(sqrt(2) 3 sigma 5/2 + 0.5)
// rotated by the angle, Gaussian window (size 2), trilinear split over
// (x, y, orientation) bins, then L2-normalise, clamp at 0.2, renormalise
// (pallas_sift.py:378-385). Contract: ops/sift_kernels.py::descriptors.
//
// What bounds them on the H100: arithmetic per contributing window pixel
// (an expf, for B3 also fmodf, a rotation and 10 hat weights, then 2 (B2)
// or up to 8 (B3) weighted bin adds), not memory: a window of up to
// ~115x115 pixels of two float planes is read once and hits L1/L2. The
// TPU kernels lane-packed several keypoints per grid step and reduced bins
// with one-hot matmuls; here one thread block walks one keypoint slot, its
// threads striding over the window. Blocks at or past the live count (read
// from device memory, so the host never synchronises) write zeros and
// exit.
//
// B2's design against that bound: most launches hold few keypoints (a
// 512x384 frame gives 649, 358, 93, 37, 20, 5, 1, 1 on its eight levels),
// so a launch lasts as long as one keypoint's chain of pixels, about 130
// cycles each for a warp, and the design spends threads on shortening it:
// a block of 256 threads walks one keypoint slot, 2 to 10 pixels a thread
// for windows of 17^2 to 49^2. (A warp per keypoint, 9 to 75 pixels a
// lane, was tried first and was slower than the design it replaced:
// PERF.md has both times.) Each thread
// keeps its 36 bins in a column of a [bin][thread] shared array (36 KB, no
// opt-in): a thread touches only its own column, so there are no bank
// conflicts, no atomics, and no runtime-indexed private array (which the
// compiler puts in local memory, a 144-byte stack frame). Threads stride
// over the keypoint's own box, |d| <= min(wr, the level's static radius)
// clipped to the image, by rows and columns with one division per thread,
// not per pixel, a few pixels at a time so that their loads overlap; the
// box bounds are whole numbers, so they are exactly the plain version's
// |d| <= wr and in-image tests, and r^2 < wr^2 + 0.6 is tested in the same
// float order. The tail is parallel and in a fixed order: in every warp
// lane l sums bin l over the warp's 32 columns, starting at its own column
// so that every step reads 32 different banks, and bins 32..35 are summed
// by groups of 4 lanes over 4 columns each and a three-step shuffle tree;
// then 36 threads add the 8 warps' sums in ascending order.
//
// B3's design against that bound: each thread keeps its 128 bins in a
// column of a [bin][thread] array in dynamic shared memory (64 KB), not in
// a runtime-indexed private array, which the compiler puts in local memory
// (a 544-byte stack frame, every bin add a round trip through L1); a
// thread touches only its own column, so there are no bank conflicts and
// no atomics. Threads stride over the box of the window that
// vl/sift.c:1352-1357 bounds, not over the level's whole static square,
// and skip a pixel before its expf once the rotated offset lies outside
// the +-2.5 support of the spatial hats (it would add nothing). The tail
// is parallel and in a fixed order: each warp sums 32 bins across the 128
// columns (4 column reads per lane, then a shuffle-down tree), and both
// norms are block shuffle reductions.
//
// Determinism: every sum runs in a fixed order, so two runs give the same
// bits, and with no float atomics. The summation orders differ from the
// plain version's (and from the earlier designs'), so the results agree to
// f32 rounding: B3 atol 2e-6, B2 rtol 1e-5 (atol 1e-5 x max).
//
// Exactness of window membership: compiled with --fmad=false and written
// in the JAX operation order, so every floor and `<` that decides which
// pixels enter the window sees the same floats as the reference.
#include "api.h"

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kEpsF = 1.19209290e-07f;  // VL_EPSILON_F
constexpr int kOriBins = 36;
constexpr int kOriThreads = 256;
constexpr int kOriBatch = 2;  // pixels a thread loads before it adds any
constexpr int kDescBins = 128;  // 4 x 4 spatial x 8 orientation
constexpr int kDescThreads = 128;

// jnp.mod for a positive divisor: C fmod, then shift negative remainders
__device__ __forceinline__ float mod_pos(float x, float y) {
  const float r = fmodf(x, y);
  return (r != 0.f && r < 0.f) ? r + y : r;
}

__global__ void __launch_bounds__(kOriThreads)
orientation_hist_kernel(const float* __restrict__ mod,
                        const float* __restrict__ ang, int h, int w,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys,
                        const float* __restrict__ sigmas,
                        const int* __restrict__ n_valid, int radius,
                        float* __restrict__ hist) {
  __shared__ float bins[kOriBins][kOriThreads];
  __shared__ float part[kOriThreads / 32][kOriBins];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* out = hist + (long long)k * kOriBins;
  // the slot's entries are read beside the live count, not after it
  const float x = xs[k];
  const float y = ys[k];
  const float sigma = sigmas[k];
  const int xi = (int)floorf(x + 0.5f);
  const int yi = (int)floorf(y + 0.5f);
  const bool ok = k < n_valid[0] && xi >= 0 && xi <= w - 1 && yi >= 0 &&
                  yi <= h - 1;
  if (!ok) {  // uniform across the block
    if (tid < kOriBins) out[tid] = 0.f;
    return;
  }
  const float sigmaw = 1.5f * sigma;
  const float wr = fmaxf(floorf(3.0f * sigmaw), 1.0f);
  const float wr2 = wr * wr + 0.6f;
  const float den = 2.0f * (sigmaw * sigmaw);
  float* mine = &bins[0][tid];  // this thread's column: bin b at mine[b * T]
#pragma unroll
  for (int b = 0; b < kOriBins; ++b) mine[b * kOriThreads] = 0.f;

  // the window's box: |d| <= wr (a whole number) inside the level's static
  // radius and inside the image
  const int reach = (int)fminf(wr, (float)radius);
  const int x_lo = max(-reach, -xi);
  const int y_lo = max(-reach, -yi);
  const int bw = min(reach, w - 1 - xi) - x_lo + 1;
  const int bh = min(reach, h - 1 - yi) - y_lo + 1;
  // pixel tid, tid + T, tid + 2 T, ... of the box in scan order
  const int step_row = kOriThreads / bw;
  const int step_col = kOriThreads - step_row * bw;
  int row = tid / bw;
  int col = tid - row * bw;
  while (row < bh) {
    // kOriBatch pixels at a time: their loads are in flight before the
    // first bin add
    int pix[kOriBatch];
    float r2[kOriBatch];
    bool in[kOriBatch];
#pragma unroll
    for (int u = 0; u < kOriBatch; ++u) {
      const int dxi = x_lo + col;
      const int dyi = y_lo + row;
      const float dx = ((float)xi + (float)dxi) - x;
      const float dy = ((float)yi + (float)dyi) - y;
      r2[u] = dx * dx + dy * dy;
      in[u] = row < bh && r2[u] < wr2;
      pix[u] = (yi + dyi) * w + (xi + dxi);
      row += step_row;
      col += step_col;
      if (col >= bw) {
        col -= bw;
        ++row;
      }
    }
    float m[kOriBatch], a[kOriBatch];
#pragma unroll
    for (int u = 0; u < kOriBatch; ++u) {
      m[u] = in[u] ? mod[pix[u]] : 0.f;
      a[u] = in[u] ? ang[pix[u]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kOriBatch; ++u) {
      if (!in[u]) continue;
      const float mw = m[u] * expf(-r2[u] / den);
      const float fbin = 36.0f * a[u] / kTwoPi;
      const float b0 = floorf(fbin - 0.5f);
      const float rbin = fbin - b0 - 0.5f;
      const int i1 = ((int)b0 + kOriBins) % kOriBins;
      const int i2 = ((int)b0 + 1 + kOriBins) % kOriBins;
      mine[i1 * kOriThreads] += mw * (1.0f - rbin);
      mine[i2 * kOriThreads] += mw * rbin;
    }
  }
  __syncwarp();
  // this warp's 32 columns. Bin `lane` from the lane's own column on: each
  // step reads 32 different banks
  const float* cols = &bins[0][warp * 32];
  float v = 0.f;
#pragma unroll 8
  for (int s = 0; s < 32; ++s)
    v += cols[lane * kOriThreads + ((lane + s) & 31)];
  part[warp][lane] = v;
  // bins 32..35: lane l takes bin 32 + (l & 3) over columns 4 (l >> 2) ..
  // + 3, rotated by l & 3 so that 4 lanes of a group read 4 banks; then the
  // 8 groups are summed by a shuffle-down tree
  const int b = 32 + (lane & 3);
  const int c0 = (lane >> 2) * 4;
  float u = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    u += cols[b * kOriThreads + c0 + ((lane + s) & 3)];
#pragma unroll
  for (int off = 16; off >= 4; off >>= 1)
    u += __shfl_down_sync(0xffffffffu, u, off);
  if (lane < kOriBins - 32) part[warp][32 + lane] = u;
  __syncthreads();
  if (tid < kOriBins) {
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < kOriThreads / 32; ++g) sum += part[g][tid];
    out[tid] = sum;
  }
}

// Dynamic shared memory of B3: per-thread bins, [bin][thread], 64 KB.
constexpr int kDescSmem = kDescBins * kDescThreads * (int)sizeof(float);

// Sum of v over the block's 4 warps, in a fixed order: a shuffle-down tree
// in each warp, then the warps' sums in ascending order (every thread gets
// the same bits). `wsum` holds kDescThreads / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* wsum) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kDescThreads / 32; ++k) s += wsum[k];
  __syncthreads();  // wsum may be written again by a later call
  return s;
}

__global__ void __launch_bounds__(kDescThreads)
descriptors_kernel(const float* __restrict__ mod,
                   const float* __restrict__ ang, int h, int w,
                   const float* __restrict__ xs, const float* __restrict__ ys,
                   const float* __restrict__ sigmas,
                   const float* __restrict__ angles,
                   const int* __restrict__ n_valid, int radius,
                   float magnif, float window_size, float* __restrict__ desc) {
  extern __shared__ float bins[];  // [kDescBins][kDescThreads]
  __shared__ float vals[kDescBins];
  __shared__ float wsum[kDescThreads / 32];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  float* out = desc + (long long)k * kDescBins;
  bool ok = k < n_valid[0];
  float x = 0.f, y = 0.f, sigma = 0.f, angle0 = 0.f;
  int xi = 0, yi = 0;
  if (ok) {
    x = xs[k];
    y = ys[k];
    sigma = sigmas[k];
    angle0 = angles[k];
    xi = (int)floorf(x + 0.5f);
    yi = (int)floorf(y + 0.5f);
    // guard of vl/sift.c:1321-1329; note yi < h - 1
    ok = xi >= 0 && xi < w && yi >= 0 && yi < h - 1;
  }
  if (!ok) {  // uniform across the block
    out[tid] = 0.f;
    return;
  }
  const float st0 = sinf(angle0);
  const float ct0 = cosf(angle0);
  const float sbp = magnif * sigma + 2.220446049250313e-16f;  // VL_EPSILON_D
  const float wr = floorf(1.4142135623730951f * sbp * 5.0f / 2.0f + 0.5f);
  const float fxi = (float)xi;
  const float fyi = (float)yi;
  // pixel loop bounds (vl/sift.c:1352-1357), whole numbers, inside the
  // level's static window radius as in the plain version
  const float r = (float)radius;
  const float x_lo = fmaxf(fmaxf(-wr, 1.0f - fxi), -r);
  const float x_hi = fminf(fminf(wr, (float)w - fxi - 2.0f), r);
  const float y_lo = fmaxf(fmaxf(-wr, 1.0f - fyi), -r);
  const float y_hi = fminf(fminf(wr, (float)h - fyi - 2.0f), r);
  const float win_den = 2.0f * window_size * window_size;
  float* my = bins + tid;  // this thread's column: bin b at my[b * threads]
#pragma unroll 8
  for (int b = 0; b < kDescBins; ++b) my[b * kDescThreads] = 0.f;

  const int bw = (int)(x_hi - x_lo) + 1;
  const int n_pix = x_hi < x_lo || y_hi < y_lo
                        ? 0 : bw * ((int)(y_hi - y_lo) + 1);
  for (int idx = tid; idx < n_pix; idx += kDescThreads) {
    const int row = idx / bw;
    const float dyi = y_lo + (float)row;
    const float dxi = x_lo + (float)(idx - row * bw);
    const float dx = fxi + dxi - x;
    const float dy = fyi + dyi - y;
    const float nx = (ct0 * dx + st0 * dy) / sbp;
    const float ny = (-st0 * dx + ct0 * dy) / sbp;
    // every spatial hat is 0 outside (-2.5, 2.5): nothing to add
    if (fabsf(nx) >= 2.5f || fabsf(ny) >= 2.5f) continue;
    const int pix = (yi + (int)dyi) * w + (xi + (int)dxi);
    const float theta = mod_pos(ang[pix] - angle0, kTwoPi);
    const float nt = 8.0f * theta / kTwoPi;
    const float win = expf(-(nx * nx + ny * ny) / win_den);
    const float base = win * mod[pix];
    float wx[4], wy[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float c = (float)b - 1.5f;
      wx[b] = fmaxf(0.f, 1.0f - fabsf(nx - c));
      wy[b] = fmaxf(0.f, 1.0f - fabsf(ny - c));
    }
    // the circular orientation hat is non-zero on floor(nt) and the next bin
    const int t_lo = (int)floorf(nt);
    int tb[2];
    float wt[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = ((t_lo + e) % 8 + 8) % 8;
      float d = fabsf(nt - (float)t);
      d = fminf(d, 8.0f - d);
      tb[e] = t;
      wt[e] = fmaxf(0.f, 1.0f - d);
    }
#pragma unroll
    for (int by = 0; by < 4; ++by) {
      if (wy[by] == 0.f) continue;
      const float zy = base * wy[by];
#pragma unroll
      for (int bx = 0; bx < 4; ++bx) {
        if (wx[bx] == 0.f) continue;
        const float z = zy * wx[bx];
        const int cell = (by * 4 + bx) * 8;
        my[(cell + tb[0]) * kDescThreads] += z * wt[0];
        my[(cell + tb[1]) * kDescThreads] += z * wt[1];
      }
    }
  }
  __syncthreads();
  // fixed-order reduction, warp w taking bins 32w .. 32w + 31: lane l adds
  // the columns l, l + 32, l + 64, l + 96 of a bin (one conflict-free row
  // read per step), then a shuffle-down tree puts the bin's sum in lane 0
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int b = warp * 32; b < warp * 32 + 32; ++b) {
    const float* row = bins + b * kDescThreads + lane;
    float v = ((row[0] + row[32]) + row[64]) + row[96];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) vals[b] = v;
  }
  __syncthreads();
  // normalise -> clamp 0.2 -> renormalise (vl/sift.c:1415-1436)
  float d = vals[tid];
  float norm = sqrtf(block_sum(d * d, wsum)) + kEpsF;
  d = fminf(d / norm, 0.2f);
  norm = sqrtf(block_sum(d * d, wsum)) + kEpsF;
  out[tid] = d / norm;
}

}  // namespace

extern "C" cudaError_t cvs_orientation_hist(const float* mod,
                                            const float* ang, int h, int w,
                                            const float* x, const float* y,
                                            const float* sigma,
                                            const int* n_valid, int n,
                                            int radius, float* hist,
                                            cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  orientation_hist_kernel<<<n, kOriThreads, 0, stream>>>(
      mod, ang, h, w, x, y, sigma, n_valid, radius, hist);
  return cudaGetLastError();
}

extern "C" cudaError_t cvs_descriptors(const float* mod, const float* ang,
                                       int h, int w, const float* x,
                                       const float* y, const float* sigma,
                                       const float* angle,
                                       const int* n_valid, int n, int radius,
                                       float magnif, float window_size,
                                       float* desc, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  // the 64 KB of dynamic shared memory need an opt-in, once per device
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(descriptors_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDescSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = true;
  }
  descriptors_kernel<<<n, kDescThreads, kDescSmem, stream>>>(
      mod, ang, h, w, x, y, sigma, angle, n_valid, radius, magnif,
      window_size, desc);
  return cudaGetLastError();
}
