// Native data loader: multi-threaded JPEG decode + bilinear resize.
//
// The reference's ingest path is cv2.imread + torchvision Resize inside
// torch DataLoader workers (reference: codes/get_dataloader.py:63-69,
// train.py:355-378). Here libjpeg decode and resize to the fixed staging
// size run in C++ worker threads, handing the Python side one contiguous
// uint8 (N, S, S, 3) batch ready for upload (the crop and the scaling to
// [0, 1] happen on the device, data/pipeline.py).
//
// C ABI only, consumed through ctypes. Built at first use by
// data/native_loader.py:
//   g++ -O3 -march=native -shared -fPIC -o build/libmmst_loader-<hash>.so
//       loader.cpp -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// Decode one JPEG file to RGB8 (optionally DCT-prescaled to cover `target`).
// Returns true on success.
bool decode_jpeg(const char* path, std::vector<uint8_t>* pixels, int* w,
                 int* h, int target) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain prescale: decode at the smallest 1/8..8/8 scale that still
  // covers the resize target (huge win on large sources, e.g. WikiArt
  // scans; the reference's cv2 path decodes at full size).
  if (target > 0) {
    int num = 8;
    while (num > 1 &&
           (cinfo.image_width * (num - 1)) / 8 >= JDIMENSION(target) &&
           (cinfo.image_height * (num - 1)) / 8 >= JDIMENSION(target)) {
      --num;
    }
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  pixels->resize(size_t(*w) * (*h) * 3);
  const size_t stride = size_t(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels->data() + size_t(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
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
// ok[i] = 1 on success, 0 on failure (caller falls back per-file).
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
      if (decode_jpeg(paths[i], &pixels, &w, &h, resize_to) && w > 0 && h > 0) {
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

int mmst_loader_version() { return 1; }

}  // extern "C"
