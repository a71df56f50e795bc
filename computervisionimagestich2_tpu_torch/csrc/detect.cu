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
// What bounds it on the H100: device memory, one pass over the [S+2, H, W]
// stacks (the output is a few thousand coordinates), and below ~10 MB of
// DoG the launch itself: an empty launch lasts ~2 us, more than the bytes
// of a 512x384 image's four octaves take. The TPU kernel's DMA ring, lane
// rolls and one-hot extraction loop do not carry over. The design:
// - ONE launch detects all the octaves of an image: the DoG stacks depend
//   on the Gaussian levels only, never on a detection, so the extractor
//   builds them first (models/sift.py).
// - A block owns a band of kBandRows image rows of one (octave, level) and
//   walks it 128 columns at a time. A thread tests four pixels of one
//   column, one below the other: it reads the 3 x 3 values (columns x
//   levels) of the six image rows around them straight from device memory
//   through L1 (54 independent loads, 13.5 a pixel instead of 26; each row's
//   extrema with and without its centre serve the pixels above, on and
//   below it). The four 32-pixel chunks of a row go to four warps at once,
//   each ballots its hits, and after one barrier every warp places its own
//   in ascending x behind the row's running count and the chunks before it
//   (__popc) in the band's shared hit list. With the default peak threshold
//   of 0 every pixel passes the gate and needs all 26 neighbours, and a
//   512x384 image's launch is bound by its instruction count: staging the
//   rows in shared memory first (built and measured: 12.8-15.7 us an image)
//   costs more instructions per value than the loads it saves.
// - The scan-order position of a band's hits is the sum of the capped row
//   counts of every band before it in its octave: a single-pass prefix scan
//   with decoupled look-back over the blocks. A block takes its logical
//   number from a ticket (so every lower number has started and a block
//   only ever waits for blocks that run), publishes its band's counts in a
//   64-bit status word, sums its predecessors' words back to the nearest
//   inclusive prefix (256 at a time in one warp), publishes its own inclusive
//   prefix, and scatters its hits straight into coords / valid. The last
//   band of an octave knows the octave's totals: it writes n_total and the
//   zeros past the kept hits. The launcher zeroes the status words and the
//   ticket with a memset on the same stream, before the kernel.
// - No atomic decides an order (the ticket only names a block; positions
//   come from the scan over logical numbers), so two runs give equal bits.
#include <math_constants.h>

#include "api.h"

namespace {

constexpr int kRowCap = 128;    // hits kept per image row
constexpr int kBandRows = 8;    // rows per block
constexpr int kTileCols = 128;  // columns tested between two barriers
constexpr int kChunks = kTileCols / 32;  // warps per row
constexpr int kRowsPerThread = 4;        // pixels of a column per thread
constexpr int kThreads = kBandRows * kTileCols / kRowsPerThread;
static_assert(kChunks * 32 == kRowCap, "a row's warps scatter its kept hits");
constexpr int kMaxOctaves = 8;
constexpr int kSpinLimit = 1 << 22;  // polls before a stuck scan traps
constexpr int kLookBack = 8;  // status words a lane polls per round

struct Octave {
  const float* dog;  // [s_out + 2, h, w]
  long long* coords;
  unsigned char* valid;
  int* n_total;
  int s_out, h, w, capacity;
  int block0;  // logical number of the octave's first block
};

struct Params {
  Octave oct[kMaxOctaves];
  int n_oct;
  float gate;
};

// Status word of a block: flag (2 bits: 0 not yet, 1 the band's own counts,
// 2 the inclusive prefix up to and including the band), uncapped count (31
// bits), capped count (31 bits). One 64-bit store publishes all three.
constexpr unsigned long long kOwn = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned kCountMask = 0x7fffffffu;

__device__ __forceinline__ unsigned long long pack(unsigned long long flag,
                                                   unsigned capped,
                                                   unsigned uncapped) {
  return flag | ((unsigned long long)uncapped << 31) | capped;
}

__global__ void __launch_bounds__(kThreads)
detect_octaves_kernel(const Params p, unsigned long long* status) {
  __shared__ unsigned short hits[kBandRows][kRowCap];  // x of the kept hits
  __shared__ int chunk_n[2][kBandRows][kChunks];  // hits per chunk, by tile
  __shared__ int row_n[kBandRows];    // uncapped hits per row
  __shared__ int row_off[kBandRows];  // capped hits in the band's rows before
  __shared__ int s_id;
  __shared__ unsigned s_base_capped, s_base_uncapped, s_band_capped,
      s_band_uncapped;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wrp = tid >> 5;

  // the ticket lives behind the last status word
  if (tid == 0)
    s_id = (int)atomicAdd((unsigned*)(status + gridDim.x), 1u);
  __syncthreads();
  const int id = s_id;
  // the block's octave, by static indices: the table stays in the kernel's
  // parameter space
  Octave oc = p.oct[0];
#pragma unroll
  for (int o = 1; o < kMaxOctaves; ++o)
    if (o < p.n_oct && id >= p.oct[o].block0) oc = p.oct[o];
  const int h = oc.h, w = oc.w;
  const int n_bands = (h + kBandRows - 1) / kBandRows;
  const int local = id - oc.block0;  // (s, band) in scan order
  const int s = local / n_bands;     // output level s <-> DoG level s + 1
  const int y0 = (local - s * n_bands) * kBandRows;
  const long long plane = (long long)h * w;
  const float* base = oc.dog + s * plane;

  // ---- detection: warp `wrp` owns chunk `chunk` of the band's rows row0 to
  // row0 + 3 in every tile
  const int row0 = (wrp / kChunks) * kRowsPerThread;
  const int chunk = wrp % kChunks;
  int n[kRowsPerThread];  // uncapped hits of the rows so far
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) n[j] = 0;
  // an image without an interior pixel holds no hit and is never read
  for (int x0 = 0, t = 0; h >= 3 && w >= 3 && x0 < w;
       x0 += kTileCols, t ^= 1) {
    const int x = x0 + chunk * 32 + lane;
    // loads stay inside the image: a pixel off the interior reads its
    // neighbour's values and is masked below
    const float* col = base + min(max(x, 1), w - 2);
    float ctr[kRowsPerThread], nmax[kRowsPerThread], nmin[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      nmax[j] = -CUDART_INF_F;
      nmin[j] = CUDART_INF_F;
    }
#pragma unroll
    for (int j = -1; j <= kRowsPerThread; ++j) {  // the six rows around them
      const float* rp =
          col + (long long)min(max(y0 + row0 + j, 0), h - 1) * w;
      // the row's 3 x 3 values without the centre one, then with it
      float c = 0.f, hi = -CUDART_INF_F, lo = CUDART_INF_F;
#pragma unroll
      for (int l = 0; l < 3; ++l) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const float u = rp[l * plane + dx];
          if (l == 1 && dx == 0) {
            c = u;
          } else {
            hi = fmaxf(hi, u);
            lo = fminf(lo, u);
          }
        }
      }
      if (j >= 0 && j < kRowsPerThread) {
        ctr[j] = c;
        nmax[j] = fmaxf(nmax[j], hi);
        nmin[j] = fminf(nmin[j], lo);
      }
      hi = fmaxf(hi, c);
      lo = fminf(lo, c);
      if (j >= 1) {  // the pixel above this row
        nmax[j - 1] = fmaxf(nmax[j - 1], hi);
        nmin[j - 1] = fminf(nmin[j - 1], lo);
      }
      if (j + 1 < kRowsPerThread) {  // the pixel below it
        nmax[j + 1] = fmaxf(nmax[j + 1], hi);
        nmin[j + 1] = fminf(nmin[j + 1], lo);
      }
    }
    unsigned b[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int y = y0 + row0 + j;
      const float v = ctr[j];
      const bool hit = x >= 1 && x <= w - 2 && y >= 1 && y <= h - 2 &&
                       ((v >= p.gate && v > nmax[j]) ||
                        (v <= -p.gate && v < nmin[j]));
      b[j] = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) chunk_n[t][row0 + j][chunk] = __popc(b[j]);
    }
    __syncthreads();  // chunk_n[t] is written again two barriers from here
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      int pos = n[j] + __popc(b[j] & ((1u << lane) - 1u));
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int m = chunk_n[t][row0 + j][c];
        if (c < chunk) pos += m;
        n[j] += m;
      }
      if ((b[j] >> lane & 1u) && pos < kRowCap)
        hits[row0 + j][pos] = (unsigned short)x;
    }
  }
  if (lane == 0 && chunk == 0) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) row_n[row0 + j] = n[j];
  }
  __syncthreads();

  // ---- the band's place in the octave's list: decoupled look-back (warp 0)
  if (wrp == 0) {
    const int mine = lane < kBandRows ? row_n[lane] : 0;
    unsigned incl_c = (unsigned)min(mine, kRowCap), incl_u = (unsigned)mine;
#pragma unroll
    for (int d = 1; d < kBandRows; d <<= 1) {
      const unsigned uc = __shfl_up_sync(0xffffffffu, incl_c, d);
      const unsigned uu = __shfl_up_sync(0xffffffffu, incl_u, d);
      if (lane >= d) {
        incl_c += uc;
        incl_u += uu;
      }
    }
    if (lane < kBandRows) row_off[lane] = (int)incl_c - min(mine, kRowCap);
    const unsigned band_c = __shfl_sync(0xffffffffu, incl_c, kBandRows - 1);
    const unsigned band_u = __shfl_sync(0xffffffffu, incl_u, kBandRows - 1);
    volatile unsigned long long* st = status;
    if (lane == 0)
      st[id] = pack(local == 0 ? kPrefix : kOwn, band_c, band_u);
    unsigned base_c = 0, base_u = 0;
    int spins = 0;
    // a round polls the 32 * kLookBack nearest predecessors at once, lane l
    // the words near - 32 k - l; past the octave's start a word is a prefix
    // of 0
    for (int near = id - 1; near >= oc.block0; near -= 32 * kLookBack) {
      unsigned long long word[kLookBack];
      bool pending;
      do {
        pending = false;
#pragma unroll
        for (int k = 0; k < kLookBack; ++k) {
          const int j = near - 32 * k - lane;
          word[k] = kPrefix;
          if (j >= oc.block0) word[k] = st[j];
          pending |= (word[k] >> 62) == 0;
        }
        if (++spins > kSpinLimit) __trap();
      } while (__any_sync(0xffffffffu, pending));
      bool found = false;
#pragma unroll
      for (int k = 0; k < kLookBack; ++k) {
        if (found) continue;  // uniform: the ballots below decide it
        const unsigned prefixes =
            __ballot_sync(0xffffffffu, (word[k] >> 62) == 2);
        // sum up to and including the nearest prefix
        const bool take = !prefixes || lane <= __ffs(prefixes) - 1;
        base_c += __reduce_add_sync(
            0xffffffffu, take ? (unsigned)(word[k] & kCountMask) : 0u);
        base_u += __reduce_add_sync(
            0xffffffffu, take ? (unsigned)((word[k] >> 31) & kCountMask) : 0u);
        found = prefixes != 0;
      }
      if (found) break;
    }
    if (lane == 0) {
      if (local != 0) st[id] = pack(kPrefix, base_c + band_c, base_u + band_u);
      s_base_capped = base_c;
      s_base_uncapped = base_u;
      s_band_capped = band_c;
      s_band_uncapped = band_u;
    }
  }
  __syncthreads();

  // ---- scatter the band's hits: a row's four warps, 32 hits each
  const int cap = oc.capacity;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int row = row0 + j;
    const int k = chunk * 32 + lane;
    const long long slot = (long long)s_base_capped + row_off[row] + k;
    if (k < min(row_n[row], kRowCap) && slot < cap) {
      oc.coords[3 * slot] = s;
      oc.coords[3 * slot + 1] = y0 + row;
      oc.coords[3 * slot + 2] = hits[row][k];
      oc.valid[slot] = 1;
    }
  }
  // ---- the octave's last band: n_total and the zeros past the kept hits
  if (local == oc.s_out * n_bands - 1) {
    if (tid == 0) oc.n_total[0] = (int)(s_base_uncapped + s_band_uncapped);
    const long long total = (long long)s_base_capped + s_band_capped;
    for (long long z = (total < cap ? total : cap) + tid; z < cap;
         z += kThreads) {
      oc.coords[3 * z] = 0;
      oc.coords[3 * z + 1] = 0;
      oc.coords[3 * z + 2] = 0;
      oc.valid[z] = 0;
    }
  }
}

}  // namespace

extern "C" cudaError_t cvs_detect_compact(int n_oct, const float* const* dog,
                                          const int* dims, float gate,
                                          long long* coords,
                                          unsigned char* valid, int* n_total,
                                          unsigned long long* status,
                                          int status_len,
                                          cudaStream_t stream) {
  if (n_oct < 1 || n_oct > kMaxOctaves) return cudaErrorInvalidValue;
  Params p{};
  p.n_oct = n_oct;
  p.gate = gate;
  int blocks = 0;
  long long slot = 0;
  for (int o = 0; o < n_oct; ++o) {
    const int* d = dims + 4 * o;
    // the hit list keeps x in 16 bits
    if (d[0] < 1 || d[1] < 1 || d[2] < 1 || d[2] > 65535 || d[3] < 1)
      return cudaErrorInvalidValue;
    p.oct[o] = Octave{dog[o], coords + 3 * slot, valid + slot, n_total + o,
                      d[0], d[1], d[2], d[3], blocks};
    blocks += d[0] * ((d[1] + kBandRows - 1) / kBandRows);
    slot += d[3];
  }
  if (status_len != blocks + 1) return cudaErrorInvalidValue;
  // the scan's status words and its ticket start at zero
  cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * status_len, stream);
  if (err != cudaSuccess) return err;
  detect_octaves_kernel<<<blocks, kThreads, 0, stream>>>(p, status);
  return cudaGetLastError();
}
