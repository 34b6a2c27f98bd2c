// The port's CCITT decoders (native/fax.cpp), driven through
// native/tiff.cpp for a TIFF's strips or tiles. No library beyond
// libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>

#include <vector>

namespace mmst_fax {

// What libtiff keeps from one strip or tile of an image to the next
// (its Fax3CodecState): the run arrays, whose stale entries a damaged
// row may read, and the "no EOL" mode that a T.4 strip whose EOL is
// missing turns on for the rest of the image's strips.
struct State {
  bool noeol = false;
  std::vector<uint32_t> runs;
};

// Decode one strip or tile of `rows` rows of `width` pixels, `rowbytes`
// bytes a row, into out (rows * rowbytes bytes), as libtiff's fax codec
// (tif_fax3.c) does for Pillow: compression 2 (Modified Huffman, rows
// byte-aligned), 32771 (the same, rows aligned to 16-bit words of the
// file, `offset` being where `in` starts in it), 3 (T.4: `options` is the
// T4Options tag, bit 0 two-dimensional coding) or 4 (T.6), with the
// image's State from the strips decoded before. The bits are
// read most significant first (FillOrder 1; the caller reverses the bytes
// of FillOrder 2). White runs are 0 bits, black runs 1 bits; bits of a row
// past its width, and the rows a T.6 strip that ends early does not reach,
// keep what out held. Throws std::runtime_error where libtiff's decoder
// returns an error: the data ends before the last row (T.6: before the
// second row), a row overflows the run arrays, or a row's width cannot be
// held.
void decode(int compression, int options, const uint8_t* in, size_t n,
            uint64_t offset, int width, int rows, int64_t rowbytes,
            uint8_t* out, State& st);

}  // namespace mmst_fax
