// Pillow's PCX run-length decoder (libImaging/PcxDecode.c) written for the
// port. A byte with its top two bits set is a run: its low six bits count
// the copies of the next byte (0 gives none); any other byte is itself.
// A row holds `bytes` bytes (PcxImagePlugin's planes x stride); a run may
// not pass a row's end (IMAGING_CODEC_OVERRUN: the decoder stops that run,
// takes the row as it is and goes on, and Pillow refuses the image once
// its decoder returns). Each row's planes are then moved together as the
// unpackers read them, where they lie further apart. A run
// packet whose second byte is not there waits for more data, as Pillow's
// decoder does: where the data ends before the last row, the image is
// truncated.

#include "pcx.h"

#include <cstring>
#include <stdexcept>

namespace mmst_pcx {

int rle_decode(const uint8_t* data, size_t n, int64_t bytes, int64_t xsize,
               int64_t ysize, int bits, uint8_t* out) {
  if (bytes <= 0 || xsize <= 0 || ysize <= 0)
    throw std::runtime_error("PCX: bad geometry");
  int64_t x = 0, y = 0;
  int status = 0;
  uint8_t* row = out;
  size_t p = 0;
  for (;;) {
    if (p >= n) return 1;
    if ((data[p] & 0xC0) == 0xC0) {
      if (n - p < 2) return 1;
      for (int k = data[p] & 0x3F; k > 0; --k) {
        if (x >= bytes) {
          status = 2;
          break;
        }
        row[x++] = data[p + 1];
      }
      p += 2;
    } else {
      row[x++] = data[p++];
    }
    if (x >= bytes) {
      // the planes moved together, a plane's bytes apart: bit planes
      // (the unpacker's 2 or 4 bits a pixel) (xsize + 7) / 8 bytes, the
      // others xsize bytes, the planes counted as the row holds them
      int64_t width = xsize, bands = bytes / xsize, stride = 0;
      if (bits == 2 || bits == 4) {
        width = (xsize + 7) / 8;
        bands = bits;
        stride = bytes / bits;
      } else if (bands != 0) {
        stride = bytes / bands;
      }
      if (stride > width)
        for (int64_t i = 1; i < bands; ++i)   // the first band stays
          std::memmove(row + i * width, row + i * stride, size_t(width));
      x = 0;
      if (++y >= ysize) return status;
      row += bytes;
    }
  }
}

}  // namespace mmst_pcx

extern "C" {

int mmst_pcx_rle(const uint8_t* data, size_t n, int64_t bytes, int64_t xsize,
                 int64_t ysize, int bits, uint8_t* out, char* err,
                 int errlen) {
  try {
    return mmst_pcx::rle_decode(data, n, bytes, xsize, ysize, bits, out);
  } catch (const std::exception& e) {
    if (errlen > 0) {
      std::strncpy(err, e.what(), size_t(errlen) - 1);
      err[errlen - 1] = 0;
    }
    return -1;
  }
}

}  // extern "C"
