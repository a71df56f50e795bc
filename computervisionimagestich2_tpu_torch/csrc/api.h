// Plain C interface of the port's CUDA kernels (bound with ctypes from
// ops/_native.py). Every function launches on `stream`, does not
// synchronise, allocates nothing, and returns the launch's cudaError_t.
// Pointers are device pointers to contiguous float32 / int32 arrays.
#pragma once
#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// B2: raw [n, 36] orientation histograms over one gradient level
// (mod, ang: [h, w]); x, y, sigma: [n] octave-local; n_valid: [1] live count.
cudaError_t cvs_orientation_hist(const float* mod, const float* ang, int h,
                                 int w, const float* x, const float* y,
                                 const float* sigma, const int* n_valid,
                                 int n, int radius, float* hist,
                                 cudaStream_t stream);

// B3: [n, 128] SIFT descriptors, normalised, clamped at 0.2, renormalised.
cudaError_t cvs_descriptors(const float* mod, const float* ang, int h, int w,
                            const float* x, const float* y,
                            const float* sigma, const float* angle,
                            const int* n_valid, int n, int radius,
                            float magnif, float window_size, float* desc,
                            cudaStream_t stream);

// B4 (one direction): for each of the nb query rows of qry [nb, 128], the
// two smallest L1 distances to the reference rows of ref [*, 128] and the
// index of the nearest. counts: [2] = {live queries, live references}.
cudaError_t cvs_l1_two_nearest(const float* qry, const float* ref,
                               const int* counts, int nb, float* d1,
                               float* d2, int* i1, cudaStream_t stream);

// B6: inverse warp of src [src_h, src_w, channels] onto out
// [h_out, w_out, channels]; params: [10] = 8 bilinear coefficients,
// offset_x, offset_y.
cudaError_t cvs_warp_image(const float* src, int src_h, int src_w,
                           int channels, const float* params, int h_out,
                           int w_out, float* out, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
