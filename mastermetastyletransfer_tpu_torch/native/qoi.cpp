// Pillow's QOI decoder (QoiImagePlugin.py's QoiDecoder, Python in Pillow)
// written for the port, op for op as Pillow applies them:
//
//   * the previous pixel starts as (0, 0, 0, 255) and the table of seen
//     pixels empty; an empty slot reads as (0, 0, 0, 0);
//   * 0xFE: RGB, alpha from the previous pixel; 0xFF: RGBA; then by the
//     top two bits: INDEX (the slot's pixel), DIFF (2-bit differences,
//     bias 2), LUMA (a second byte: green's 6-bit difference, bias 32,
//     and red's and blue's 4-bit ones to green's, bias 8), all modulo
//     256; RUN ((low six bits) + 1 copies of the previous pixel);
//   * every op but RUN sets the previous pixel and stores it in slot
//     (3r + 5g + 7b + 11a) % 64 (a RUN stores nothing: the first
//     pixel's slot holds nothing until an op puts it there);
//   * a run may pass the image's last pixel (the rest is dropped); the
//     data must hold every op's bytes until the last pixel, and nothing
//     after it is read (the end marker is not checked).

#include "qoi.h"

#include <cstring>

namespace mmst_qoi {

int decode(const uint8_t* data, size_t n, int64_t pixels, int bands,
           uint8_t* out) {
  uint8_t seen[64][4] = {};
  uint8_t prev[4] = {0, 0, 0, 255};
  const int64_t total = pixels * bands;
  int64_t at = 0;
  size_t p = 0;
  while (at < total) {
    if (p >= n) return 1;
    const int b = data[p++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (n - p < 3) return 1;
      v[0] = data[p];
      v[1] = data[p + 1];
      v[2] = data[p + 2];
      v[3] = prev[3];
      p += 3;
    } else if (b == 0xFF) {
      if (n - p < 4) return 1;
      std::memcpy(v, data + p, 4);
      p += 4;
    } else if ((b >> 6) == 0) {
      std::memcpy(v, seen[b & 63], 4);
    } else if ((b >> 6) == 1) {
      v[0] = uint8_t(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = uint8_t(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = uint8_t(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {
      if (p >= n) return 1;
      const int second = data[p++];
      const int dg = (b & 63) - 32;
      v[0] = uint8_t(prev[0] + dg + ((second >> 4) & 15) - 8);
      v[1] = uint8_t(prev[1] + dg);
      v[2] = uint8_t(prev[2] + dg + (second & 15) - 8);
      v[3] = prev[3];
    } else {   // RUN: the previous pixel again, not stored
      for (int k = (b & 63) + 1; k > 0 && at < total; --k) {
        std::memcpy(out + at, prev, size_t(bands));
        at += bands;
      }
      continue;
    }
    std::memcpy(prev, v, 4);
    std::memcpy(seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v,
                4);
    std::memcpy(out + at, v, size_t(bands));
    at += bands;
  }
  return 0;
}

}  // namespace mmst_qoi

extern "C" {

int mmst_qoi_decode(const uint8_t* data, size_t n, int64_t pixels, int bands,
                    uint8_t* out) {
  return mmst_qoi::decode(data, n, pixels, bands, out);
}

}  // extern "C"
