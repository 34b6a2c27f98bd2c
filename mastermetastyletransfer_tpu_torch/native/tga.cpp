// Pillow's TGA run-length decoder (libImaging/TgaRleDecode.c) written for
// the port: each packet a header byte, its low 7 bits one less than the
// pixels it gives; a run (high bit set) repeats one pixel of `depth`
// bytes, a literal copies that many pixels. A run must end within its
// row (Pillow's IMAGING_CODEC_OVERRUN); a literal that passes a row's end
// goes on into the next rows. Pillow feeds the decoder whole packets as
// the file's bytes arrive, so where the data ends decides only whether
// the last row is reached. Depth 0 (a 1-bit file, which Pillow counts as
// 0 bytes a pixel) gives nothing and so reads to the data's end.

#include "tga.h"

#include <cstring>
#include <stdexcept>

namespace mmst_tga {

void rle_decode(const uint8_t* data, size_t n, int depth, int64_t linesize,
                int ysize, int bottom_up, uint8_t* out) {
  if (linesize <= 0 || ysize <= 0 || depth < 0)
    throw std::runtime_error("TGA: bad geometry");
  int64_t y = bottom_up ? ysize - 1 : 0;
  const int64_t ystep = bottom_up ? -1 : 1;
  int64_t x = 0;
  uint8_t* row = out + y * linesize;
  size_t p = 0;
  for (;;) {
    if (p >= n) throw std::runtime_error("TGA: image file is truncated");
    const int64_t count = int64_t(depth) * ((data[p] & 0x7f) + 1);
    int64_t take = count, extra = 0;
    if (data[p] & 0x80) {
      if (n - p < size_t(1 + depth))
        throw std::runtime_error("TGA: image file is truncated");
      if (x + count > linesize)
        throw std::runtime_error("TGA: a run packet crosses a row's end "
                                 "(buffer overrun)");
      for (int64_t i = 0; i < count; i += depth)
        std::memcpy(row + x + i, data + p + 1, size_t(depth));
      p += size_t(1 + depth);
    } else {
      if (int64_t(n - p) < 1 + count)
        throw std::runtime_error("TGA: image file is truncated");
      if (x + count > linesize) {
        take = linesize - x;
        extra = count - take;
      }
      std::memcpy(row + x, data + p + 1, size_t(take));
      p += size_t(1 + take);
    }
    int64_t got = take;
    for (;;) {
      x += got;
      if (x >= linesize) {   // a whole row
        x = 0;
        y += ystep;
        if (y < 0 || y >= ysize) return;
        row = out + y * linesize;
      }
      if (extra == 0) break;
      if (x > 0) break;
      got = extra >= linesize ? linesize : extra;
      std::memcpy(row + x, data + p, size_t(got));
      p += size_t(got);
      extra -= got;
    }
  }
}

}  // namespace mmst_tga

extern "C" {

int mmst_tga_rle(const uint8_t* data, size_t n, int depth, int64_t linesize,
                 int ysize, int bottom_up, uint8_t* out, char* err,
                 int errlen) {
  try {
    mmst_tga::rle_decode(data, n, depth, linesize, ysize, bottom_up, out);
    return 0;
  } catch (const std::exception& e) {
    if (errlen > 0) {
      std::strncpy(err, e.what(), size_t(errlen) - 1);
      err[errlen - 1] = 0;
    }
    return 1;
  }
}

}  // extern "C"
