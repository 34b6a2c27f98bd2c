// The byte-serial TIFF decoders of the port's own (native/tiff.cpp), bound
// by data/native_loader.py with ctypes and driven by utils/tiff.py. No
// library beyond libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>

namespace mmst_tiff {

// One strip or tile: its bytes in the file, the bytes its decode must give
// (the rows libtiff asks for), and for JPEG its segment (width, height, and
// whether it is the last strip, whose stream may hold more rows).
struct Chunk {
  uint64_t offset, count;
  int64_t need;
  int width, height, last;
};
// data/native_loader.py's TIFF_CHUNK is this layout, 40 bytes a chunk
static_assert(sizeof(Chunk) == 40, "Chunk is not TIFF_CHUNK's layout");

// Decode each chunk of data (size bytes) into out, one after another, as
// libtiff's codec gives them to Pillow: compression 5 (LZW, MSB-first
// with the early change, or the old LSB-first codes where the chunk
// starts so), 32773 (PackBits) or 7 (JPEG: the JPEGTables stream, if
// any, before each chunk's; colour 1 YCbCr turned to RGB, 2 the
// components as stored). reverse reverses each byte's bits first
// (FillOrder 2; JPEG takes its bytes as they are). Throws
// std::runtime_error naming the chunk and what is wrong: a chunk past the
// file's end or empty, a corrupt code stream, or one that ends before its
// chunk's bytes are whole; with tolerant, a chunk that fails keeps the
// bytes its codec wrote before failing (out untouched past them) and the
// next chunk is decoded, as libtiff's TIFFRGBAImage reads strips.
void decode(int compression, const uint8_t* data, size_t size,
            const Chunk* chunks, int n, int reverse, int tolerant,
            const uint8_t* tables, size_t ntables, int colour, int channels,
            uint8_t* out);

}  // namespace mmst_tiff
