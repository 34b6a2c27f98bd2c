// The port's Zstandard decoder (native/zstd.cpp), driven through
// native/tiff.cpp for a TIFF's strips or tiles. No library beyond
// libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>

namespace mmst_zstd {

// Decode one strip's bytes into out[0, need) as libtiff's ZSTDDecode
// (tif_zstd.c) does with libzstd's ZSTD_decompressStream: the first frame
// of the data, until its end, the data's end or out's end. Throws
// std::runtime_error naming what is wrong where libzstd reports an error
// on the part of the data it reads, or where out is not filled.
void decode(const uint8_t* in, size_t n, uint8_t* out, size_t need);

}  // namespace mmst_zstd
