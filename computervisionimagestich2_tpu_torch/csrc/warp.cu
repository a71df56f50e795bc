// B6: inverse warp of one image onto a panorama canvas.
//
// Replaces computervisionimagestich2_tpu/ops/pallas_warp.py::
// warp_image_onehot (_kernel). Contract: ops/warp.py::warp_image — for each
// canvas pixel (x, y) evaluate the 8-coefficient bilinear backward model at
// (x + offset_x, y + offset_y) in float32, truncate toward zero, and copy
// src[ny, nx] (all channels) or write 0 outside the source.
//
// What bounds it on the H100: memory. Each output pixel costs two 12-byte
// accesses (one gathered read, one write) against ~12 flops, so the kernel
// is bound by device-memory bytes and by the gather's sector efficiency.
// The TPU kernel needed per-tile DMA windows and a one-hot MXU matmul
// because point gathers are slow there; on Hopper a direct gather through
// L1/L2 is the natural form. Neighbouring threads take neighbouring output
// pixels of one row, whose source pixels are also near each other, so the
// gathers coalesce into few sectors.
//
// Exactness: the library is compiled with --fmad=false and the expression
// keeps the JAX operation order ((c0*x + c1*y) + (c2*x)*y) + c3, so the
// truncated indices are bit-equal to the reference; a contracted
// multiply-add would move truncf across integer boundaries.
#include "api.h"

namespace {

__global__ void warp_image_kernel(const float* __restrict__ src, int src_h,
                                  int src_w, int channels,
                                  const float* __restrict__ par, int h_out,
                                  int w_out, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)h_out * w_out) return;
  const int yy = (int)(i / w_out);
  const int xx = (int)(i - (long long)yy * w_out);
  const float x = (float)xx + par[8];
  const float y = (float)yy + par[9];
  const float xw = par[0] * x + par[1] * y + par[2] * x * y + par[3];
  const float yw = par[4] * x + par[5] * y + par[6] * x * y + par[7];
  const float tx = truncf(xw);
  const float ty = truncf(yw);
  // float-domain bounds test: equal to the int test for finite values and
  // false for NaN or values beyond the int32 range
  const bool valid = tx >= 0.f && tx < (float)src_w && ty >= 0.f &&
                     ty < (float)src_h;
  float* o = out + i * channels;
  if (valid) {
    const float* s = src + ((long long)(int)ty * src_w + (int)tx) * channels;
    for (int c = 0; c < channels; ++c) o[c] = s[c];
  } else {
    for (int c = 0; c < channels; ++c) o[c] = 0.f;
  }
}

}  // namespace

extern "C" cudaError_t cvs_warp_image(const float* src, int src_h, int src_w,
                                      int channels, const float* params,
                                      int h_out, int w_out, float* out,
                                      cudaStream_t stream) {
  const long long n = (long long)h_out * w_out;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  warp_image_kernel<<<blocks, threads, 0, stream>>>(
      src, src_h, src_w, channels, params, h_out, w_out, out);
  return cudaGetLastError();
}
