// Native image codec + batch loader.
//
// The runtime/IO layer of the framework: replaces CImg's BMP decode/encode
// (CImg.h load_bmp/save_bmp) with a small C++ library and
// adds a threaded batch loader (the data-loader role; the reference's
// per-image load threads at src/ex6/ImageProcess.cpp:44-50
// were created-then-joined and thus serial).
//
// Exposed as a plain C ABI for ctypes binding (no pybind11 in this image).
// All images are RGB8, row-major, top-down.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  size_t len;
  bool ok = true;
  uint32_t u32(size_t off) const { return off + 4 <= len ? (uint32_t)p[off] | ((uint32_t)p[off + 1] << 8) | ((uint32_t)p[off + 2] << 16) | ((uint32_t)p[off + 3] << 24) : 0; }
  int32_t i32(size_t off) const { return (int32_t)u32(off); }
  uint16_t u16(size_t off) const { return off + 2 <= len ? (uint16_t)p[off] | ((uint16_t)p[off + 1] << 8) : 0; }
};

}  // namespace

extern "C" {

// Probe a BMP buffer: returns 0 on success and fills w/h.
int bmp_probe(const uint8_t* data, size_t len, int* w, int* h) {
  if (len < 54 || data[0] != 'B' || data[1] != 'M') return -1;
  Reader r{data, len};
  int32_t width = r.i32(18);
  int32_t height = r.i32(22);
  if (width <= 0 || height == 0) return -2;
  *w = width;
  *h = height < 0 ? -height : height;
  return 0;
}

// Decode into caller-allocated out[h*w*3] (RGB, top-down). Returns 0 on ok.
int bmp_decode(const uint8_t* data, size_t len, uint8_t* out) {
  int w, h;
  if (bmp_probe(data, len, &w, &h) != 0) return -1;
  Reader r{data, len};
  uint32_t pixel_off = r.u32(10);
  uint32_t header_size = r.u32(14);
  int32_t raw_h = r.i32(22);
  uint16_t bpp = r.u16(28);
  uint32_t compression = r.u32(30);
  if (compression != 0 && compression != 3) return -3;
  bool flipped = raw_h > 0;  // bottom-up storage
  size_t row_stride = ((size_t)w * bpp + 31) / 32 * 4;
  if (pixel_off + row_stride * h > len) return -4;

  const uint8_t* palette = data + 14 + header_size;
  uint32_t n_colors = r.u32(46);
  if (n_colors == 0) n_colors = 256;

  for (int y = 0; y < h; ++y) {
    int sy = flipped ? h - 1 - y : y;
    const uint8_t* row = data + pixel_off + (size_t)sy * row_stride;
    uint8_t* dst = out + (size_t)y * w * 3;
    if (bpp == 24) {
      for (int x = 0; x < w; ++x) {
        dst[x * 3 + 0] = row[x * 3 + 2];
        dst[x * 3 + 1] = row[x * 3 + 1];
        dst[x * 3 + 2] = row[x * 3 + 0];
      }
    } else if (bpp == 32) {
      for (int x = 0; x < w; ++x) {
        dst[x * 3 + 0] = row[x * 4 + 2];
        dst[x * 3 + 1] = row[x * 4 + 1];
        dst[x * 3 + 2] = row[x * 4 + 0];
      }
    } else if (bpp == 8) {
      if (14 + header_size + n_colors * 4 > len) return -5;
      for (int x = 0; x < w; ++x) {
        const uint8_t* c = palette + (size_t)row[x] * 4;
        dst[x * 3 + 0] = c[2];
        dst[x * 3 + 1] = c[1];
        dst[x * 3 + 2] = c[0];
      }
    } else {
      return -6;
    }
  }
  return 0;
}

// Required output buffer size for bmp_encode of a w*h RGB image.
size_t bmp_encode_size(int w, int h) {
  size_t row_stride = ((size_t)w * 3 + 3) / 4 * 4;
  return 54 + row_stride * (size_t)h;
}

// Encode RGB8 top-down into a 24-bit BMP. out must hold bmp_encode_size().
// Returns bytes written.
size_t bmp_encode(const uint8_t* rgb, int w, int h, uint8_t* out) {
  size_t row_stride = ((size_t)w * 3 + 3) / 4 * 4;
  size_t total = 54 + row_stride * (size_t)h;
  std::memset(out, 0, 54);
  out[0] = 'B';
  out[1] = 'M';
  auto put32 = [&](size_t off, uint32_t v) {
    out[off] = v & 0xff;
    out[off + 1] = (v >> 8) & 0xff;
    out[off + 2] = (v >> 16) & 0xff;
    out[off + 3] = (v >> 24) & 0xff;
  };
  auto put16 = [&](size_t off, uint16_t v) {
    out[off] = v & 0xff;
    out[off + 1] = (v >> 8) & 0xff;
  };
  put32(2, (uint32_t)total);
  put32(10, 54);
  put32(14, 40);
  put32(18, (uint32_t)w);
  put32(22, (uint32_t)h);
  put16(26, 1);
  put16(28, 24);
  put32(34, (uint32_t)(row_stride * h));
  put32(38, 2835);
  put32(42, 2835);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = rgb + (size_t)(h - 1 - y) * w * 3;  // bottom-up
    uint8_t* row = out + 54 + (size_t)y * row_stride;
    std::memset(row, 0, row_stride);
    for (int x = 0; x < w; ++x) {
      row[x * 3 + 0] = src[x * 3 + 2];
      row[x * 3 + 1] = src[x * 3 + 1];
      row[x * 3 + 2] = src[x * 3 + 0];
    }
  }
  return total;
}

// Threaded batch load: decode n BMP files concurrently into a contiguous
// out buffer (all images must share w*h; first image sets the shape).
// paths: array of n C strings. Returns 0 on full success, else the count
// of failed files.
int bmp_load_batch(const char** paths, int n, uint8_t* out, int w, int h,
                   int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  std::vector<int> failures(n, 0);
  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      FILE* f = std::fopen(paths[i], "rb");
      if (!f) { failures[i] = 1; continue; }
      std::fseek(f, 0, SEEK_END);
      long len = std::ftell(f);
      std::fseek(f, 0, SEEK_SET);
      std::vector<uint8_t> buf((size_t)len);
      size_t got = std::fread(buf.data(), 1, (size_t)len, f);
      std::fclose(f);
      if (got != (size_t)len) { failures[i] = 1; continue; }
      int fw, fh;
      if (bmp_probe(buf.data(), buf.size(), &fw, &fh) != 0 ||
          fw != w || fh != h) { failures[i] = 1; continue; }
      if (bmp_decode(buf.data(), buf.size(),
                     out + (size_t)i * w * h * 3) != 0) failures[i] = 1;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& t : threads) t.join();
  int bad = 0;
  for (int v : failures) bad += v;
  return bad;
}

}  // extern "C"
