// The port's Zstandard decoder (native/zstd.cpp), driven through
// native/tiff.cpp for a TIFF's strips or tiles, and whole for the frames
// of a checkpoint's files (utils/ocdbt.py, utils/zarr.py). No library
// beyond libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace mmst_zstd {

// Decode one strip's bytes into out[0, need) as libtiff's ZSTDDecode
// (tif_zstd.c) does with libzstd's ZSTD_decompressStream: the first frame
// of the data, until its end, the data's end or out's end. Throws
// std::runtime_error naming what is wrong where libzstd reports an error
// on the part of the data it reads, or where out is not filled.
void decode(const uint8_t* in, size_t n, uint8_t* out, size_t need);

// Decode the one frame that in[0, n) holds, as ZSTD_decompress does, into
// an output that grows as the blocks decode: the frame's content size,
// where its header gives one, is checked, not needed. Throws
// std::runtime_error naming what is wrong where the data is not one whole
// frame (cut, or bytes after it), a block does not decode, the content
// size or checksum disagrees, or the output would pass limit bytes.
std::vector<uint8_t> decode_frame(const uint8_t* in, size_t n, size_t limit);

}  // namespace mmst_zstd
