// The port's QOI decoder (native/qoi.cpp), bound by data/native_loader.py
// and driven by utils/qoi.py. No library beyond libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>

namespace mmst_qoi {

// Pillow's QoiDecoder (QoiImagePlugin.py) on data[0, n), the ops after
// the 14-byte header: `pixels` pixels of `bands` (3 or 4) bytes into out.
// Returns 0, or 1 where the data ends before the last pixel (Pillow's
// IndexError or ValueError).
int decode(const uint8_t* data, size_t n, int64_t pixels, int bands,
           uint8_t* out);

}  // namespace mmst_qoi
