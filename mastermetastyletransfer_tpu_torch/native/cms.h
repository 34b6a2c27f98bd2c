// The port's 8-bit colour transform (native/cms.cpp), bound by
// data/native_loader.py and driven by utils/cms.py. No library beyond
// libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>

namespace mmst_cms {

// LittleCMS's evaluation of an 8-bit -> 8-bit transform through its
// optimised 16-bit CLUT: each input byte b taken as the word b * 257,
// TetrahedralInterp16 on `clut` (grid^3 nodes of 3 words, the first
// input the slowest), each output word to 8 bits as FROM_16_TO_8.
// in: n pixels of 3 bytes; out: n pixels of 3 bytes.
void tetrahedral8(const uint8_t* in, int64_t n, const uint16_t* clut,
                  int grid, uint8_t* out);

}  // namespace mmst_cms
