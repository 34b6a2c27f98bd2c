// The port's TGA run-length decoder (native/tga.cpp), bound by
// data/native_loader.py and driven by utils/tga.py. No library beyond
// libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>

namespace mmst_tga {

// Pillow's TgaRleDecode.c on data[0, n): packets of `depth` bytes a pixel
// into rows of `linesize` bytes, the first row at the bottom of out
// (`ysize` rows) where bottom_up, else at its top. Throws
// std::runtime_error where Pillow refuses: the data ends before the last
// row ("image file is truncated"), or a run packet crosses a row's end
// (an overrun). A literal packet may cross rows; data after the last row
// is ignored.
void rle_decode(const uint8_t* data, size_t n, int depth, int64_t linesize,
                int ysize, int bottom_up, uint8_t* out);

}  // namespace mmst_tga
