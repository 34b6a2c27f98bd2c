// Native data loader: multi-threaded JPEG decode + bilinear resize.
//
// The reference's ingest path is cv2.imread + torchvision Resize inside
// torch DataLoader workers (reference: codes/get_dataloader.py:63-69,
// train.py:355-378). Here the port's own JPEG decoder (native/jpeg.cpp,
// libjpeg-turbo's default arithmetic, no library) and the resize to the
// fixed staging size run in C++ worker threads, handing the Python side one
// contiguous uint8 (N, S, S, 3) batch ready for upload (the crop and the
// scaling to [0, 1] happen on the device, data/pipeline.py). Each image
// decodes with the JAX package's DCT-domain prescale: at the smallest
// n/8 scale that still covers the target, chosen by the JAX loader's own
// loop, so that the batches are the JAX loader's bit for bit.
//
// C ABI only, consumed through ctypes. Built at first use by
// data/native_loader.py:
//   g++ -O3 -march=native -shared -fPIC -o build/libmmst_loader-<hash>.so
//       loader.cpp jpeg.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <thread>
#include <vector>

#include "jpeg.h"

namespace {

// Decode one JPEG file to RGB8, DCT-prescaled to cover `target` as the JAX
// package's loader asks libjpeg to (its native/loader.cpp; a file cut short
// is read past its end as libjpeg's jpeg_stdio_src reads it, a fake EOI).
// Returns true on success; false also for the kinds that the JAX loader's
// libjpeg (libjpeg-turbo 2.1, JCS_RGB) does not decode, CMYK and YCCK (no
// such colour conversion) and lossless frames, so that they take its
// fallback: the full-size decode and Pillow's BILINEAR (data/pipeline.py).
bool decode_jpeg(const char* path, std::vector<uint8_t>* pixels, int* w,
                 int* h, int target) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::vector<uint8_t> bytes;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    bytes.insert(bytes.end(), chunk, chunk + got);
  std::fclose(f);
  try {
    const mmst_jpeg::Info info = mmst_jpeg::frame_info(bytes.data(),
                                                      bytes.size());
    if (info.components == 4 || info.lossless) return false;
    const int width = info.width, height = info.height;
    // the smallest 1/8..8/8 scale that still covers the resize target
    unsigned num = 8;
    if (target > 0) {
      while (num > 1 &&
             (unsigned(width) * (num - 1)) / 8 >= unsigned(target) &&
             (unsigned(height) * (num - 1)) / 8 >= unsigned(target)) {
        --num;
      }
    }
    *w = int((int64_t(width) * num + 7) / 8);
    *h = int((int64_t(height) * num + 7) / 8);
    pixels->resize(size_t(*w) * *h * 3);
    mmst_jpeg::decode_scaled(bytes.data(), bytes.size(), int(num),
                             pixels->data(), *w, *h);
  } catch (const std::exception&) {
    return false;
  }
  return true;
}

// Bilinear resize RGB8 (h, w) -> (s, s), PIL/torchvision-compatible
// half-pixel centers (align_corners=false).
void resize_bilinear(const uint8_t* src, int w, int h, uint8_t* dst, int s) {
  const float sx = float(w) / s;
  const float sy = float(h) / s;
  for (int y = 0; y < s; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = int(fy);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    for (int x = 0; x < s; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = int(fx);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(size_t(y0) * w + x0) * 3 + c];
        float v01 = src[(size_t(y0) * w + x1) * 3 + c];
        float v10 = src[(size_t(y1) * w + x0) * 3 + c];
        float v11 = src[(size_t(y1) * w + x1) * 3 + c];
        float top = v00 + (v01 - v00) * wx;
        float bot = v10 + (v11 - v10) * wx;
        float v = top + (bot - top) * wy;
        dst[(size_t(y) * s + x) * 3 + c] = uint8_t(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode `n` JPEG files and resize each to (resize_to, resize_to, 3) uint8,
// writing into `out` (n * resize_to * resize_to * 3 bytes, caller-owned).
// ok[i] = 1 on success, 0 on failure (the caller decodes that file
// itself, by its format).
// Returns the number of successfully decoded images.
int mmst_decode_resize_batch(const char** paths, int n, uint8_t* out,
                             int resize_to, int n_threads, uint8_t* ok) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), good(0);
  const size_t img_bytes = size_t(resize_to) * resize_to * 3;

  auto worker = [&]() {
    std::vector<uint8_t> pixels;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      if (decode_jpeg(paths[i], &pixels, &w, &h, resize_to) && w > 0 &&
          h > 0) {
        resize_bilinear(pixels.data(), w, h, out + size_t(i) * img_bytes,
                        resize_to);
        ok[i] = 1;
        good.fetch_add(1);
      } else {
        ok[i] = 0;
        std::memset(out + size_t(i) * img_bytes, 0, img_bytes);
      }
    }
  };

  std::vector<std::thread> threads;
  int nt = n_threads < n ? n_threads : n;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return good.load();
}

int mmst_loader_version() { return 4; }

}  // extern "C"
