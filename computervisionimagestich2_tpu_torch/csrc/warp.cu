// B6: inverse warp of one image onto a panorama canvas, for both warp
// models of the stitcher.
//
// Replaces computervisionimagestich2_tpu/ops/pallas_warp.py::
// warp_image_onehot (_kernel), and for warp_model="projective" the JAX
// package's gather (ops/warp.py::warp_image, which its Pallas kernel
// refuses). Contract: ops/warp.py::warp_image — for each canvas pixel
// (x, y) evaluate the backward model at (x + ox, y + oy) in float32,
// truncate toward zero, and copy src[ny, nx] (all channels) or write 0
// outside the source.
//
// What bounds it on the H100: memory. Each canvas pixel costs one gathered
// read and one write of C floats against ~20-25 float operations, so the
// kernel is bound by device-memory bytes (the canvas write above all: the
// canvas is ~3x the source at panorama sizes) and, on small canvases, by
// its launch. The TPU kernel cut the canvas into tiles, DMA'd the source
// rows a tile can reach and gathered with a one-hot matmul on the MXU,
// because point gathers are slow on a TPU; Hopper gathers through L1/L2 at
// sector granularity, so none of that machinery pays here.
//
// The design:
// - Parameters by value: the 9 coefficients, the offsets and the model
//   travel in the kernel's parameter space (CvsWarpParams), so a call
//   needs no device buffer, no host-to-device copy and no concatenation
//   before it: the caller hands over host floats it already holds.
// - Or from device memory (cvs_warp_image_dev): the 11 floats that a
//   program computed on the card (the edge plan's backward model and
//   canvas offsets), read once per thread through the read-only cache,
//   with the model as a launch argument. Nothing is read back, so the
//   warp can sit in a CUDA graph between the plan and the blend. The
//   kernel body is the same; only the parameters' loads differ.
// - A warp takes 128 consecutive canvas pixels (the canvas read as one
//   flat row-major array), each lane four of them, 32 apart. The lane
//   evaluates the model for its four pixels and issues the four
//   independent gathers before it stores anything, so four loads are in
//   flight per thread where the one-pixel design had one and waited on
//   its latency; each load instruction of the warp reads 32 neighbouring
//   pixels' sources, which coalesce as well as the one-pixel design's.
// - For C = 3 the warp's 128 pixels (1,536 bytes) go out through a
//   warp-private staging buffer in shared memory as 96 16-byte vector
//   stores, every one aligned (a segment starts at a multiple of 128
//   pixels); the canvas's last, partial segment and other channel counts
//   store scalars.
// - The model is a template parameter: two kernels (warp_bilinear_kernel,
//   warp_projective_kernel) from one body, chosen once per launch.
//
// Tried and dropped (PERF.md, PR 7): four consecutive pixels of one row
// per thread with three 16-byte stores each. Its load instructions touch
// 32 pixels 4 apart, three times the sectors of a coalesced read, and it
// took twice the one-pixel design's time on the stitch's canvases.
//
// Exactness: the library is compiled with --fmad=false and the
// expressions keep the JAX operation order, so the truncated indices are
// bit-equal to the reference (a contracted multiply-add would move truncf
// across integer boundaries):
// - bilinear: ((c0*x + c1*y) + (c2*x)*y) + c3;
// - projective (JAX ops/warp.py::projective_xy): den = (c6*x + c7*y) + c8,
//   |den| < 1e-12 -> 1e-12, then ((c0*x + c1*y) + c2) / den. The division
//   is IEEE round-to-nearest: nvcc's default -prec-div=true, which no
//   fast-math flag of the build overrides.
// The bounds test stays in the float domain: equal to the int test for
// finite values and false for NaN, +-inf and values beyond the int32
// range, so a projective warp whose horizon crosses the canvas writes 0
// there instead of wrapping into an index.
#include <stdint.h>

#include "api.h"

namespace {

constexpr int kPix = 4;                  // canvas pixels per lane
constexpr int kSeg = 32 * kPix;          // consecutive pixels per warp
constexpr int kThreads = 256;

template <int kModel>
__device__ __forceinline__ void backward_map(const CvsWarpParams& p, float x,
                                             float y, float& xw, float& yw) {
  if (kModel == CVS_WARP_BILINEAR) {
    xw = p.c[0] * x + p.c[1] * y + p.c[2] * x * y + p.c[3];
    yw = p.c[4] * x + p.c[5] * y + p.c[6] * x * y + p.c[7];
  } else {
    float den = p.c[6] * x + p.c[7] * y + p.c[8];
    if (fabsf(den) < 1e-12f) den = 1e-12f;
    xw = (p.c[0] * x + p.c[1] * y + p.c[2]) / den;
    yw = (p.c[3] * x + p.c[4] * y + p.c[5]) / den;
  }
}

template <int kModel>
__device__ __forceinline__ void warp_segment(const float* __restrict__ src,
                                             int src_h, int src_w,
                                             int channels,
                                             const CvsWarpParams& p,
                                             int h_out, int w_out,
                                             float* __restrict__ out) {
  __shared__ float stage[kThreads / 32][kSeg * 3];
  const int lane = threadIdx.x & 31;
  const long long n = (long long)h_out * w_out;
  const long long p0 =
      (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * kSeg;
  if (p0 >= n) return;  // whole warps only
  long long q = p0 + lane;  // this lane's pixels: q, q + 32, q + 64, q + 96
  int yy = (int)(q / w_out);
  int xx = (int)(q - (long long)yy * w_out);

  int pix[kPix];  // source pixel index, or -1 outside the source or canvas
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    pix[k] = -1;
    if (q + 32 * k < n) {
      float xw, yw;
      backward_map<kModel>(p, (float)xx + p.ox, (float)yy + p.oy, xw, yw);
      const float tx = truncf(xw);
      const float ty = truncf(yw);
      if (tx >= 0.f && tx < (float)src_w && ty >= 0.f && ty < (float)src_h)
        pix[k] = (int)ty * src_w + (int)tx;
    }
    xx += 32;
    while (xx >= w_out) {
      xx -= w_out;
      ++yy;
    }
  }

  if (channels == 3) {
    float v[3 * kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const float* s = src + (long long)max(pix[k], 0) * 3;
      const bool in = pix[k] >= 0;
      v[3 * k + 0] = in ? __ldg(s + 0) : 0.f;
      v[3 * k + 1] = in ? __ldg(s + 1) : 0.f;
      v[3 * k + 2] = in ? __ldg(s + 2) : 0.f;
    }
    float* o = out + p0 * 3;
    if (p0 + kSeg <= n && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      float* st = stage[threadIdx.x >> 5];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        st[(lane + 32 * k) * 3 + 0] = v[3 * k + 0];
        st[(lane + 32 * k) * 3 + 1] = v[3 * k + 1];
        st[(lane + 32 * k) * 3 + 2] = v[3 * k + 2];
      }
      __syncwarp();
      const float4* s4 = reinterpret_cast<const float4*>(st);
      float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
      for (int j = 0; j < 3; ++j) o4[lane + 32 * j] = s4[lane + 32 * j];
    } else {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (q + 32 * k < n) {
          float* ok = o + (lane + 32 * k) * 3;
          ok[0] = v[3 * k + 0];
          ok[1] = v[3 * k + 1];
          ok[2] = v[3 * k + 2];
        }
      }
    }
    return;
  }
  for (int k = 0; k < kPix; ++k) {
    if (q + 32 * k >= n) break;
    const float* s = src + (long long)max(pix[k], 0) * channels;
    float* ok = out + (q + 32 * k) * channels;
    for (int c = 0; c < channels; ++c)
      ok[c] = pix[k] >= 0 ? __ldg(s + c) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    warp_bilinear_kernel(const float* __restrict__ src, int src_h, int src_w,
                         int channels, CvsWarpParams p, int h_out, int w_out,
                         float* __restrict__ out) {
  warp_segment<CVS_WARP_BILINEAR>(src, src_h, src_w, channels, p, h_out,
                                  w_out, out);
}

__global__ void __launch_bounds__(kThreads)
    warp_projective_kernel(const float* __restrict__ src, int src_h,
                           int src_w, int channels, CvsWarpParams p,
                           int h_out, int w_out, float* __restrict__ out) {
  warp_segment<CVS_WARP_PROJECTIVE>(src, src_h, src_w, channels, p, h_out,
                                    w_out, out);
}

// The device-parameter entry's kernels: the same body, the parameters
// loaded from device memory (CvsWarpParams's c[9], ox, oy as 11 floats)
// instead of the parameter space, so a CUDA graph that computed the model
// and offsets on the device replays the warp with their new values.
template <int kModel>
__device__ __forceinline__ CvsWarpParams load_params(
    const float* __restrict__ params) {
  CvsWarpParams p;
#pragma unroll
  for (int i = 0; i < 9; ++i) p.c[i] = __ldg(params + i);
  p.ox = __ldg(params + 9);
  p.oy = __ldg(params + 10);
  p.model = kModel;
  return p;
}

__global__ void __launch_bounds__(kThreads)
    warp_bilinear_kernel_dev(const float* __restrict__ src, int src_h,
                             int src_w, int channels,
                             const float* __restrict__ params, int h_out,
                             int w_out, float* __restrict__ out) {
  const CvsWarpParams p = load_params<CVS_WARP_BILINEAR>(params);
  warp_segment<CVS_WARP_BILINEAR>(src, src_h, src_w, channels, p, h_out,
                                  w_out, out);
}

__global__ void __launch_bounds__(kThreads)
    warp_projective_kernel_dev(const float* __restrict__ src, int src_h,
                               int src_w, int channels,
                               const float* __restrict__ params, int h_out,
                               int w_out, float* __restrict__ out) {
  const CvsWarpParams p = load_params<CVS_WARP_PROJECTIVE>(params);
  warp_segment<CVS_WARP_PROJECTIVE>(src, src_h, src_w, channels, p, h_out,
                                    w_out, out);
}

unsigned grid_blocks(int h_out, int w_out) {
  const long long segments = ((long long)h_out * w_out + kSeg - 1) / kSeg;
  return (unsigned)((segments * 32 + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" cudaError_t cvs_warp_image(const float* src, int src_h, int src_w,
                                      int channels, CvsWarpParams params,
                                      int h_out, int w_out, float* out,
                                      cudaStream_t stream) {
  if (params.model != CVS_WARP_BILINEAR && params.model != CVS_WARP_PROJECTIVE)
    return cudaErrorInvalidValue;
  const unsigned blocks = grid_blocks(h_out, w_out);
  if (blocks == 0) return cudaSuccess;
  if (params.model == CVS_WARP_BILINEAR)
    warp_bilinear_kernel<<<blocks, kThreads, 0, stream>>>(
        src, src_h, src_w, channels, params, h_out, w_out, out);
  else
    warp_projective_kernel<<<blocks, kThreads, 0, stream>>>(
        src, src_h, src_w, channels, params, h_out, w_out, out);
  return cudaGetLastError();
}

extern "C" cudaError_t cvs_warp_image_dev(const float* src, int src_h,
                                          int src_w, int channels,
                                          const float* params, int model,
                                          int h_out, int w_out, float* out,
                                          cudaStream_t stream) {
  if (model != CVS_WARP_BILINEAR && model != CVS_WARP_PROJECTIVE)
    return cudaErrorInvalidValue;
  const unsigned blocks = grid_blocks(h_out, w_out);
  if (blocks == 0) return cudaSuccess;
  if (model == CVS_WARP_BILINEAR)
    warp_bilinear_kernel_dev<<<blocks, kThreads, 0, stream>>>(
        src, src_h, src_w, channels, params, h_out, w_out, out);
  else
    warp_projective_kernel_dev<<<blocks, kThreads, 0, stream>>>(
        src, src_h, src_w, channels, params, h_out, w_out, out);
  return cudaGetLastError();
}
