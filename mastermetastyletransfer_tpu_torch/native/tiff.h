// The byte-serial TIFF decoders of the port's own (native/tiff.cpp), bound
// by data/native_loader.py with ctypes and driven by utils/tiff.py. No
// library beyond libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>

#include <vector>

#include "fax.h"

namespace mmst_tiff {

// One strip or tile: its bytes in the file, the bytes its decode must give
// (the rows libtiff asks for), its segment (width, height: JPEG's frame,
// CCITT's rows), whether it is the last strip (whose JPEG stream may hold
// more rows), and, written by decode, whether its codec succeeded (0) or
// failed (1).
struct Chunk {
  uint64_t offset, count;
  int64_t need;
  int width, height, last, status;
};
// data/native_loader.py's TIFF_CHUNK is this layout, 40 bytes a chunk
static_assert(sizeof(Chunk) == 40, "Chunk is not TIFF_CHUNK's layout");

// What libtiff and the libraries under it keep from one strip or tile of
// an image to the next: the CCITT codec's state, and the tables libjpeg
// holds (JPEGTables, then those each strip or tile defines) with the
// YCbCr subsampling libtiff takes from the first strip where no tag
// gives it.
struct State {
  mmst_fax::State fax;
  bool jpeg_started = false;
  std::vector<uint8_t> jpeg_tables;
  int jpeg_h = 0, jpeg_v = 0;
};

// JPEG's options: bits 0-3 and 4-7 the YCbCrSubsampling tag's
// horizontal and vertical factors (0 where the tag is absent),
// kJpegPlanar for PlanarConfiguration 2.
constexpr int kJpegPlanar = 1 << 8;

// Decode each chunk of data (size bytes) into out, one after another, as
// libtiff's codec gives them to Pillow: compression 5 (LZW, MSB-first
// with the early change, or the old LSB-first codes where the chunk
// starts so), 32773 (PackBits), 7 (JPEG: the JPEGTables stream, if any,
// before each chunk's; colour 1 YCbCr turned to RGB, 2 the components as
// stored), 2, 3, 4 and 32771 (CCITT, native/fax.cpp; options the
// T4Options tag) or 50000 (Zstandard, native/zstd.cpp), with `st` what
// libtiff keeps from strip to strip of the image (JPEG: its tables start
// as `tables`, the JPEGTables stream, at the image's first call). reverse reverses
// each byte's bits first (FillOrder 2; JPEG takes its bytes as they are).
// Throws std::runtime_error naming the chunk and what is wrong: a chunk
// past the file's end or empty, a corrupt code stream, or one that ends
// before its chunk's bytes are whole; with tolerant, a chunk that fails
// keeps the bytes its codec wrote before failing (out untouched past
// them), its status is set and the next chunk is decoded, as libtiff's
// TIFFRGBAImage reads strips. With carry, each chunk but the first starts
// from the bytes of the one before (libtiff and Pillow decode every strip
// or tile of a call into one buffer); the first from what out holds.
void decode(int compression, const uint8_t* data, size_t size,
            Chunk* chunks, int n, int reverse, int tolerant, int carry,
            const uint8_t* tables, size_t ntables, int colour, int channels,
            int options, State& st, uint8_t* out);

}  // namespace mmst_tiff
