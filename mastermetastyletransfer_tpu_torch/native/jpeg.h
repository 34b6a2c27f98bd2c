// JPEG decoder and baseline encoder of the port's own (native/jpeg.cpp),
// shared by the batch loader (native/loader.cpp) and the C ABI that
// data/native_loader.py binds with ctypes. No library beyond libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace mmst_jpeg {

// A frame's size and what the batch loader routes by.
struct Info {
  int width, height, components;
  bool lossless;
  // the sampling factors of the first component; whether the others' are
  // all 1 x 1
  int h0 = 0, v0 = 0;
  bool others_1x1 = true;
};

// The frame header of an 8-bit JPEG that the decoder reads (sequential or
// progressive, Huffman or arithmetic-coded, or lossless; 1, 3 or 4
// components), from its markers up to the frame header. Throws
// std::runtime_error naming what is wrong or unsupported (e.g.
// "hierarchical JPEG (SOF5) is not supported"), a frame above the
// decompression-bomb limit included.
Info frame_info(const uint8_t* data, size_t size);

// Decode such a JPEG, of the width and height that frame_info gave, to
// RGB8 in rgb (height x width x 3, rows top to bottom), as PIL's
// convert("RGB") gives it: damaged data as PIL's libjpeg recovers from it,
// and a cut file read only where PIL reads it (every row out before the
// data ends; an arithmetic-coded scan not across PIL's 64 KiB reads).
// Throws as frame_info does, and where PIL refuses the file.
void decode(const uint8_t* data, size_t size, uint8_t* rgb, int width,
            int height);

// The colour conversions of decode_colour.
constexpr int kColourPil = 0;   // as decode
constexpr int kColourYcc = 1;   // YCbCr to RGB, whatever the markers say
constexpr int kColourRaw = 2;   // the components as stored, one a byte

// Decode as decode does, with the colour conversion given: kColourRaw
// writes the frame's 1, 3 or 4 components a pixel (height x width x
// components), the others RGB8. libtiff's JPEG codec takes its strips and
// tiles so (JPEGCOLORMODE_RGB, or JCS_UNKNOWN).
void decode_colour(const uint8_t* data, size_t size, uint8_t* out,
                   int width, int height, int colour);

// Decode as decode_colour does one strip or tile of a JPEG TIFF for
// libtiff's JPEG codec: a frame whose first scan codes every component is
// read to that scan's end, the markers after unread (libtiff ignores what
// jpeg_finish_decompress meets), and past the data's end libtiff's source
// reads a fake EOI. Returns the decoder's tables at the end
// as a tables-only stream (SOI, DQT, DHT, EOI), which libjpeg keeps for
// the next strip or tile.
std::vector<uint8_t> decode_tiff_chunk(const uint8_t* data, size_t size,
                                       uint8_t* out, int width, int height,
                                       int colour);

// The same at n/8 of the frame's size (n in 1..8), as libjpeg-turbo 2.1
// (the JAX loader's) gives it with scale_num = n, scale_denom = 8 and its
// defaults: width and height are ceil(W * n / 8) and ceil(H * n / 8) of the
// frame's W x H. n = 8 is decode but for block smoothing's edges, which
// the two versions take differently, and for the data's end: the JAX
// loader's jpeg_stdio_src reads a fake EOI past it, so a cut file is read
// (its blocks past the cut grey, or as the earlier scans left them). A
// lossless frame is decoded at n = 8 only.
void decode_scaled(const uint8_t* data, size_t size, int n, uint8_t* rgb,
                   int width, int height);

// Encode RGB8 (height x width x 3) as a baseline 4:2:0 JFIF at `quality`
// (1-100, IJG scaling of the standard tables), standard Huffman tables:
// the bytes libjpeg writes with its defaults at that quality.
std::vector<uint8_t> encode(const uint8_t* rgb, int width, int height,
                            int quality);

}  // namespace mmst_jpeg
