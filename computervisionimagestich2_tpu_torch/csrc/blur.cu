// B8: one 1-D pass of the separable Gaussian (ops/gaussian.py::
// _conv1d_axis): out[l] = sum_j taps[j] * x[clamp(l + j - r, 0, L - 1)]
// along one axis, with edge replication (VL_PAD_BY_CONTINUITY).
//
// Replaces no pl.pallas_call: the JAX package leaves this shift-and-add to
// XLA (computervisionimagestich2_tpu/ops/gaussian.py). On the card the
// port's plain version ran it as one index_select pad and 2k - 1
// elementwise kernels a pass, each over the whole plane: ~117 taps a
// pass over an octave, so ~470 launches an octave and the plane read and
// written about five times a tap.
//
// What bounds it on the H100: at 4K, bytes (a 2160 x 3840 float32 plane
// is 33 MB, and the arithmetic, two separately rounded operations a tap,
// is of the same order as one read and one write at 3.35 TB/s); at
// 512 x 384, the launch (a plane is under 1 MB). The design answers the
// bytes with one read and one write a pass and the launches with one
// launch a pass.
//
// The design: the tensor is viewed as [outer, L, inner], L the blurred
// axis and inner the contiguous elements after it ([..., H, W] along W:
// inner = 1; along H: inner = W; [H, W, C] along W: inner = C). A block
// stages a tile of tile_o x (tile_l + 2r) x tile_i inputs in shared
// memory, the halo's rows clamped into the axis (no padded copy in device
// memory), in the working type; neighbouring threads load neighbouring
// inner elements (or, with inner = 1, neighbouring positions of a row),
// so the loads coalesce, and each thread keeps kLoads of them in flight.
// Then each thread computes M outputs of the tile, kThreads apart,
// walking its taps over shared memory: the lanes of a warp read
// consecutive words, free of bank conflicts. The tile adapts to the view:
// tile_i = inner up to 64 (else 32), tile_l along the axis and tile_o
// rows so that a block holds 256 to 2048 outputs and the grid about two
// waves over the SMs; M = ceil(tile / kThreads). The taps are read from
// the device constant the caller keeps (so a CUDA graph captures a
// pointer that never changes) and staged in shared memory. The input may
// be strided (an octave's decimated base, a resized blend level): its
// outer and axis strides are arguments; the output is contiguous.
//
// Exactness: the sum runs in tap order, acc = t0 * x0, then acc = acc +
// tj * xj, each product and each sum rounded on its own to the working
// type (float32, or bfloat16 with bfloat16 taps; see mul and add): the
// bits of PyTorch's mul and add kernels in the plain version.
#include <cuda_bf16.h>
#include <limits.h>

#include "api.h"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPer = 8;   // outputs per thread
constexpr int kLoads = 8;    // staging loads in flight per thread
constexpr int kMaxRadius = 64;
constexpr int kSmemBytes = 48 * 1024;  // without opting in

// The working type's product and sum, each rounded once to nearest even.
// No contraction into a fused multiply-add: the build's --fmad=false for
// float32, the explicit .rn of mul.rn.bf16 / add.rn.bf16 for bfloat16.
// PyTorch's bfloat16 mul and add compute in float and round to bfloat16:
// a product of two bfloat16 values is exact in float, and a float sum of
// two of them is either exact or off by less than 2^-16 of the larger,
// far inside half a bfloat16 ulp, so one rounding gives their bits.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat16 mul(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
  return __hmul_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
  return __hadd_rn(a, b);
}

// a / b for 0 <= a < 2^24 and 1 <= b, from b's float reciprocal: the
// truncated product is off by at most one either way, and corrected.
// Several times cheaper than an integer division by a value the compiler
// does not know.
__device__ __forceinline__ int div_small(int a, int b, float inv_b) {
  int q = __float2int_rz(__int2float_rn(a) * inv_b);
  if (q * b > a)
    --q;
  else if ((q + 1) * b <= a)
    ++q;
  return q;
}

long long clamp_ll(long long v, long long lo, long long hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

// Elements of shared memory before the staged tile: the taps, rounded up
// to 16 bytes.
template <typename T>
__host__ __device__ int taps_room(int n_taps) {
  const int per16 = 16 / (int)sizeof(T);
  return (n_taps + per16 - 1) / per16 * per16;
}

// The staged tile is laid out [tile_l + 2r][tile_o][tile_i] and a block's
// outputs [tile_l][tile_o][tile_i], so output q reads staged element
// q + j * tile_o * tile_i at tap j: one pointer a thread, and the M
// outputs kThreads apart at fixed offsets from it. With tile_o = 1 (every
// launch but those on rows shorter than a tile) consecutive elements are
// consecutive in memory both ways.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    separable_blur_kernel(const T* __restrict__ x, long long outer,
                          int length, int inner, long long stride_outer,
                          long long stride_length,
                          const T* __restrict__ taps, int n_taps, int tile_o,
                          int tile_l, int tile_i, int tiles_l, int tiles_i,
                          T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* taps_s = reinterpret_cast<T*>(smem_raw);
  T* s = taps_s + taps_room<T>(n_taps);
  const int r = (n_taps - 1) / 2;
  const int row = tile_o * tile_i;  // staged elements a position
  const float inv_row = 1.0f / row, inv_tile_i = 1.0f / tile_i;
  long long b = blockIdx.x;
  const int i0 = (int)(b % tiles_i) * tile_i;
  b /= tiles_i;
  const int l0 = (int)(b % tiles_l) * tile_l;
  const long long o0 = b / tiles_l * tile_o;
  const int tid = threadIdx.x;

  for (int j = tid; j < n_taps; j += kThreads) taps_s[j] = taps[j];
  // kLoads loads in flight a thread before any is stored: one at a time
  // keeps too few bytes in flight to approach the card's bandwidth
  const int staged = (tile_l + 2 * r) * row;
  for (int e0 = tid; e0 < staged; e0 += kThreads * kLoads) {
    T v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = min(e0 + u * kThreads, staged - 1);
      const int ls = div_small(e, row, inv_row), rest = e - ls * row;
      const int ro = div_small(rest, tile_i, inv_tile_i);
      const int ii = rest - ro * tile_i;
      const long long o = min(o0 + ro, outer - 1);
      const int l = min(max(l0 - r + ls, 0), length - 1);
      const int i = min(i0 + ii, inner - 1);
      v[u] = x[o * stride_outer + (long long)l * stride_length + i];
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (e0 + u * kThreads < staged) s[e0 + u * kThreads] = v[u];
  }
  __syncthreads();

  // outputs past the tile's end read the slack after it and are dropped
  const int tile = tile_l * row;
  const T* src = s + tid;
  T acc[M];
  const T t0 = taps_s[0];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = mul(t0, src[m * kThreads]);
  for (int j = 1; j < n_taps; ++j) {
    src += row;
    const T tj = taps_s[j];
#pragma unroll
    for (int m = 0; m < M; ++m)
      acc[m] = add(acc[m], mul(tj, src[m * kThreads]));
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int q = tid + m * kThreads;
    const int lt = div_small(q, row, inv_row), rest = q - lt * row;
    const int ro = div_small(rest, tile_i, inv_tile_i);
    const int ii = rest - ro * tile_i;
    if (q < tile && o0 + ro < outer && l0 + lt < length && i0 + ii < inner)
      out[((o0 + ro) * length + l0 + lt) * (long long)inner + i0 + ii] =
          acc[m];
  }
}

template <typename T, int M>
cudaError_t launch_blur(unsigned blocks, size_t smem, cudaStream_t stream,
                        const void* x, long long outer, int length, int inner,
                        long long stride_outer, long long stride_length,
                        const void* taps, int n_taps, int tile_o, int tile_l,
                        int tile_i, int tiles_l, int tiles_i, void* out) {
  separable_blur_kernel<T, M><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), outer, length, inner, stride_outer,
      stride_length, static_cast<const T*>(taps), n_taps, tile_o, tile_l,
      tile_i, tiles_l, tiles_i, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_per(int per, unsigned blocks, size_t smem,
                       cudaStream_t stream, const void* x, long long outer,
                       int length, int inner, long long stride_outer,
                       long long stride_length, const void* taps, int n_taps,
                       int tile_o, int tile_l, int tile_i, int tiles_l,
                       int tiles_i, void* out) {
#define CVS_BLUR_CASE(M)                                                    \
  case M:                                                                   \
    return launch_blur<T, M>(blocks, smem, stream, x, outer, length, inner, \
                             stride_outer, stride_length, taps, n_taps,     \
                             tile_o, tile_l, tile_i, tiles_l, tiles_i, out);
  switch (per) {
    CVS_BLUR_CASE(1)
    CVS_BLUR_CASE(2)
    CVS_BLUR_CASE(3)
    CVS_BLUR_CASE(4)
    CVS_BLUR_CASE(5)
    CVS_BLUR_CASE(6)
    CVS_BLUR_CASE(7)
    CVS_BLUR_CASE(8)
  }
#undef CVS_BLUR_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" cudaError_t cvs_separable_blur(const void* x, long long outer,
                                          int length, int inner,
                                          long long stride_outer,
                                          long long stride_length,
                                          const void* taps, int n_taps,
                                          int bf16, void* out,
                                          cudaStream_t stream) {
  if (outer < 1 || length < 1 || inner < 1 || n_taps < 1 || n_taps % 2 == 0 ||
      (n_taps - 1) / 2 > kMaxRadius)
    return cudaErrorInvalidValue;
  const int r = (n_taps - 1) / 2;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;

  // a block's outputs: about two waves of blocks over the SMs, 256 to 2048
  const long long n = outer * length * (long long)inner;
  const long long target =
      clamp_ll(n / (2LL * sms), 256, (long long)kThreads * kMaxPer);
  const int tile_i = inner <= 64 ? inner : 32;
  int tile_l = (int)clamp_ll(target / tile_i, 1, length);
  long long tile_o = clamp_ll(target / ((long long)tile_l * tile_i), 1, outer);
  // the staged tile (and kThreads elements of slack, which the outputs
  // past the tile's end read) within 48 KB: fewer rows first, then a
  // shorter span
  const int elem = bf16 ? 2 : 4;
  const int lead = bf16 ? taps_room<__nv_bfloat16>(n_taps)
                        : taps_room<float>(n_taps);
  const int room = kSmemBytes / elem - lead - kThreads;
  if ((tile_l + 2 * r) * (long long)tile_i > room)
    tile_l = room / tile_i - 2 * r;  // >= 1: tile_i <= 64, r <= 64
  if (tile_o * (tile_l + 2 * r) * tile_i > room)
    tile_o = clamp_ll(room / ((long long)(tile_l + 2 * r) * tile_i), 1, outer);
  const long long tile = tile_o * tile_l * tile_i;
  const int per = (int)((tile + kThreads - 1) / kThreads);
  const long long tiles_o = (outer + tile_o - 1) / tile_o;
  const int tiles_l = (length + tile_l - 1) / tile_l;
  const int tiles_i = (inner + tile_i - 1) / tile_i;
  const long long blocks = tiles_o * tiles_l * tiles_i;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)elem * (lead + tile_o * (tile_l + 2 * r) * tile_i + kThreads);
  if (bf16)
    return launch_per<__nv_bfloat16>(
        per, (unsigned)blocks, smem, stream, x, outer, length, inner,
        stride_outer, stride_length, taps, n_taps, (int)tile_o, tile_l,
        tile_i, tiles_l, tiles_i, out);
  return launch_per<float>(per, (unsigned)blocks, smem, stream, x, outer,
                           length, inner, stride_outer, stride_length, taps,
                           n_taps, (int)tile_o, tile_l, tile_i, tiles_l,
                           tiles_i, out);
}
