// Plain C interface of the port's CUDA kernels (bound with ctypes from
// ops/_native.py). Every function launches on `stream`, does not
// synchronise, allocates nothing, and returns the launch's cudaError_t.
// Pointers are device pointers to contiguous float32 / int32 arrays (B8:
// float32 or bfloat16, its input strided); masks are bool arrays (one byte
// per entry), coordinates int64.
#pragma once
#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// B1: strict 26-neighbour extrema at |v| >= gate of n_oct DoG stacks (the
// octaves of one image), one launch for all. dog: host array of n_oct device
// pointers, stack o of shape [s_out + 2, h, w]; dims: host array [n_oct, 4]
// of (s_out, h, w, capacity). Per octave the hits are listed as scan-order
// (s, y, x) rows, each image row keeping its first 128, truncated at its
// capacity, zeros past the kept ones; the octaves' lists follow each other
// in coords [sum capacity, 3] and valid [sum capacity]. n_total: [n_oct],
// the uncapped hit counts. status: [status_len] 64-bit words of scratch (zeroed
// here), status_len = 1 + the sum over octaves of s_out * ceil(h / 8).
// At most 8 octaves a call.
cudaError_t cvs_detect_compact(int n_oct, const float* const* dog,
                               const int* dims, float gate, long long* coords,
                               unsigned char* valid, int* n_total,
                               unsigned long long* status, int status_len,
                               cudaStream_t stream);

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

// B7 (one direction): for each of the nb query rows of qry [nb, 128]
// with qry_valid set, the two smallest L1 distances to the rows of ref
// [na, 128] with ref_valid set and the index of the nearest; d1 = d2 = BIG
// and i1 = 0 for the other queries. Scratch: part_d [2 * ceil(na / 64) *
// nb] floats, part_i [ceil(na / 64) * nb] ints. Two launches (the tile pass
// and its merge).
cudaError_t cvs_l1_two_nearest(const float* qry, const float* ref,
                               const unsigned char* qry_valid,
                               const unsigned char* ref_valid, int nb, int na,
                               float* part_d, int* part_i, float* d1,
                               float* d2, int* i1, cudaStream_t stream);

// B4: both 2-NN directions from one distance pass. For each query row
// with qry_valid set, (d1q, d2q, i1q) over the references with ref_valid
// set, and for each such reference row (d1r, d2r, i1r) over those queries;
// BIG, BIG, 0 for the other rows. Scratch: part_d [2 * (ceil(na / 64) * nb
// + ceil(nb / 64) * na)] floats, part_i [ceil(na / 64) * nb + ceil(nb / 64)
// * na] ints. Two launches (the tile pass and its merge).
cudaError_t cvs_l1_two_nearest_bidir(const float* qry, const float* ref,
                                     const unsigned char* qry_valid,
                                     const unsigned char* ref_valid, int nb,
                                     int na, float* part_d, int* part_i,
                                     float* d1q, float* d2q, int* i1q,
                                     float* d1r, float* d2r, int* i1r,
                                     cudaStream_t stream);

// B5: Lowe-ratio match counts out [n_pairs, 2] (zeroed by the caller) over
// desc [n_images, cap, 128] with valid [n_images, cap]; pairs [n_pairs, 2] =
// (i, j). out[p, 0]: queries = image j against references = image i;
// out[p, 1]: the reverse. The pairs are walked `chunk` at a time. Scratch:
// live [n_images] ints, tile_start [chunk + 1] ints, part [chunk * 4 *
// ceil(cap / 64) * cap] floats. Three launches per chunk (plan, tile pass,
// merge and count).
cudaError_t cvs_pair_match_counts(const float* desc,
                                  const unsigned char* valid, int n_images,
                                  int cap, const int* pairs, int n_pairs,
                                  float ratio, int chunk, int* live,
                                  int* tile_start, float* part, int* out,
                                  cudaStream_t stream);

// B6: inverse warp of src [src_h, src_w, channels] (at least one pixel)
// onto out [h_out, w_out, channels], with the parameters by value: the
// backward model's coefficients (8 bilinear ones, c[8] unused, or the
// row-major 3x3 homography), the canvas offset added to each pixel's
// (x, y), and the model. cudaErrorInvalidValue for an unknown model.
enum { CVS_WARP_BILINEAR = 0, CVS_WARP_PROJECTIVE = 1 };
typedef struct {
  float c[9];
  float ox, oy;
  int model;
} CvsWarpParams;
cudaError_t cvs_warp_image(const float* src, int src_h, int src_w,
                           int channels, CvsWarpParams params, int h_out,
                           int w_out, float* out, cudaStream_t stream);
// B6 with its parameters in device memory: params points to 11 floats
// on the card (c[0..8], ox, oy as in CvsWarpParams), the model is a launch
// argument. The same kernel body and the same bits as cvs_warp_image.
cudaError_t cvs_warp_image_dev(const float* src, int src_h, int src_w,
                               int channels, const float* params, int model,
                               int h_out, int w_out, float* out,
                               cudaStream_t stream);

// B8: one pass of the separable Gaussian along the middle axis of x viewed
// as [outer, length, inner]: out[o, l, i] = sum_j taps[j] * x[o, clamp(l +
// j - r, 0, length - 1), i], r = (n_taps - 1) / 2, summed in tap order with
// each product and each sum rounded to the working type (float32, or
// bfloat16 with bf16 = 1; taps and out in the same type). x's element (o,
// l, i) lies at o * stride_outer + l * stride_length + i; out is
// contiguous. n_taps odd, r at most 64, else cudaErrorInvalidValue.
cudaError_t cvs_separable_blur(const void* x, long long outer, int length,
                               int inner, long long stride_outer,
                               long long stride_length, const void* taps,
                               int n_taps, int bf16, void* out,
                               cudaStream_t stream);

#ifdef __cplusplus
}
#endif
