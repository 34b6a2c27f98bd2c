// The port's PCX decoder (native/pcx.cpp), bound by data/native_loader.py
// and driven by utils/pcx.py. No library beyond libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>

namespace mmst_pcx {

// Pillow's PcxDecode.c on data[0, n): rows of `bytes` bytes (every plane
// of a row) into out (`ysize` rows of `bytes`), each row's planes moved
// together where the decoder moves them: for an unpacker of 2 or 4 `bits`
// a pixel (bit planes) from bytes / bits apart to (xsize + 7) / 8, for
// the others from bytes / (bytes / xsize) apart to xsize. Returns 0
// where every row was decoded, 1 where the data ends first (Pillow's
// "image file is truncated"), 2 where a run packet passed a row's end
// (IMAGING_CODEC_OVERRUN; Pillow goes on, and refuses the image at its
// end).
int rle_decode(const uint8_t* data, size_t n, int64_t bytes, int64_t xsize,
               int64_t ysize, int bits, uint8_t* out);

}  // namespace mmst_pcx
