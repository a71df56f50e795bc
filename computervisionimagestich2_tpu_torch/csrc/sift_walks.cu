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
// What bounds them on the H100: arithmetic and latency per window pixel
// (an expf, for B3 also fmodf and 16 hat weights, then 2 or 8 scattered
// bin updates), not memory: a window of up to ~115x115 pixels of two
// float planes is read once and hits L1/L2. The TPU kernels lane-packed
// several keypoints per grid step and reduced bins with one-hot matmuls;
// here one thread block walks one keypoint slot, its threads striding over
// the window. Blocks at or past the live count (read from device memory,
// so the host never synchronises) write zeros and exit.
//
// Determinism: each thread accumulates its own bins in a private array;
// the block then sums the per-thread (B2) or per-warp (B3) partials in a
// fixed order, so two runs give the same bits. The summation order differs
// from the reference's reductions, so results agree to f32 rounding.
//
// Exactness of window membership: compiled with --fmad=false and written
// in the JAX operation order, so every floor and `<` that decides which
// pixels enter the window sees the same floats as the reference.
#include "api.h"

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kEpsF = 1.19209290e-07f;  // VL_EPSILON_F
constexpr int kOriBins = 36;
constexpr int kOriThreads = 128;
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
  __shared__ float part[kOriThreads][kOriBins + 1];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  float* out = hist + (long long)k * kOriBins;
  bool ok = k < n_valid[0];
  float x = 0.f, y = 0.f, sigma = 0.f;
  int xi = 0, yi = 0;
  if (ok) {
    x = xs[k];
    y = ys[k];
    sigma = sigmas[k];
    xi = (int)floorf(x + 0.5f);
    yi = (int)floorf(y + 0.5f);
    ok = xi >= 0 && xi <= w - 1 && yi >= 0 && yi <= h - 1;
  }
  if (!ok) {  // uniform across the block
    if (tid < kOriBins) out[tid] = 0.f;
    return;
  }
  const float sigmaw = 1.5f * sigma;
  const float wr = fmaxf(floorf(3.0f * sigmaw), 1.0f);
  const float wr2 = wr * wr + 0.6f;
  const float den = 2.0f * (sigmaw * sigmaw);
  float acc[kOriBins];
#pragma unroll
  for (int b = 0; b < kOriBins; ++b) acc[b] = 0.f;

  const int p = 2 * radius + 1;
  for (int idx = tid; idx < p * p; idx += kOriThreads) {
    const int dyi = idx / p - radius;
    const int dxi = idx - (idx / p) * p - radius;
    const int ix = xi + dxi;
    const int iy = yi + dyi;
    if (ix < 0 || ix > w - 1 || iy < 0 || iy > h - 1) continue;
    const float fdx = (float)dxi;
    const float fdy = (float)dyi;
    if (fabsf(fdx) > wr || fabsf(fdy) > wr) continue;
    const float dx = ((float)xi + fdx) - x;
    const float dy = ((float)yi + fdy) - y;
    const float r2 = dx * dx + dy * dy;
    if (!(r2 < wr2)) continue;
    const float mw = mod[iy * w + ix] * expf(-r2 / den);
    const float fbin = 36.0f * ang[iy * w + ix] / kTwoPi;
    const float b0 = floorf(fbin - 0.5f);
    const float rbin = fbin - b0 - 0.5f;
    const int i1 = ((int)b0 + kOriBins) % kOriBins;
    const int i2 = ((int)b0 + 1 + kOriBins) % kOriBins;
    acc[i1] += mw * (1.0f - rbin);
    acc[i2] += mw * rbin;
  }
#pragma unroll
  for (int b = 0; b < kOriBins; ++b) part[tid][b] = acc[b];
  __syncthreads();
  if (tid < kOriBins) {
    float s = 0.f;
    for (int t = 0; t < kOriThreads; ++t) s += part[t][tid];
    out[tid] = s;
  }
}

__global__ void __launch_bounds__(kDescThreads)
descriptors_kernel(const float* __restrict__ mod,
                   const float* __restrict__ ang, int h, int w,
                   const float* __restrict__ xs, const float* __restrict__ ys,
                   const float* __restrict__ sigmas,
                   const float* __restrict__ angles,
                   const int* __restrict__ n_valid, int radius, float magnif,
                   float window_size, float* __restrict__ desc) {
  __shared__ float warp_part[kDescThreads / 32][kDescBins];
  __shared__ float vals[kDescBins];
  __shared__ float norm;
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
  // pixel loop bounds (vl/sift.c:1352-1357)
  const float x_lo = fmaxf(-wr, 1.0f - fxi);
  const float x_hi = fminf(wr, (float)w - fxi - 2.0f);
  const float y_lo = fmaxf(-wr, 1.0f - fyi);
  const float y_hi = fminf(wr, (float)h - fyi - 2.0f);
  const float win_den = 2.0f * window_size * window_size;

  float acc[kDescBins];
#pragma unroll
  for (int b = 0; b < kDescBins; ++b) acc[b] = 0.f;

  const int p = 2 * radius + 1;
  for (int idx = tid; idx < p * p; idx += kDescThreads) {
    const float dyi = (float)(idx / p - radius);
    const float dxi = (float)(idx - (idx / p) * p - radius);
    if (dxi < x_lo || dxi > x_hi || dyi < y_lo || dyi > y_hi) continue;
    const int pix = (yi + (int)dyi) * w + (xi + (int)dxi);
    const float theta = mod_pos(ang[pix] - angle0, kTwoPi);
    const float dx = fxi + dxi - x;
    const float dy = fyi + dyi - y;
    const float nx = (ct0 * dx + st0 * dy) / sbp;
    const float ny = (-st0 * dx + ct0 * dy) / sbp;
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
        acc[cell + tb[0]] += z * wt[0];
        acc[cell + tb[1]] += z * wt[1];
      }
    }
  }
  // fixed-order reduction: a butterfly within each warp, then the warps
  // in order
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll 4
  for (int b = 0; b < kDescBins; ++b) {
    float v = acc[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) warp_part[warp][b] = v;
  }
  __syncthreads();
  float d = 0.f;
#pragma unroll
  for (int wi = 0; wi < kDescThreads / 32; ++wi) d += warp_part[wi][tid];
  // normalise -> clamp 0.2 -> renormalise (vl/sift.c:1415-1436)
  vals[tid] = d * d;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int b = 0; b < kDescBins; ++b) s += vals[b];
    norm = sqrtf(s) + kEpsF;
  }
  __syncthreads();
  d = fminf(d / norm, 0.2f);
  vals[tid] = d * d;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int b = 0; b < kDescBins; ++b) s += vals[b];
    norm = sqrtf(s) + kEpsF;
  }
  __syncthreads();
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
  descriptors_kernel<<<n, kDescThreads, 0, stream>>>(
      mod, ang, h, w, x, y, sigma, angle, n_valid, radius, magnif,
      window_size, desc);
  return cudaGetLastError();
}
