// WebP decoder of the port's own (native/webp.cpp), bound by
// data/native_loader.py with ctypes. No library beyond libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>

namespace mmst_webp {

// The canvas of a WebP file: its width and height in pixels.
struct Info {
  int width, height;
};

// Check the RIFF container as libwebp's demuxer does (every chunk, every
// frame's bitstream header and bounds) and give the canvas size. Throws
// std::runtime_error naming what is wrong: a truncated or corrupt file, or
// a canvas above the decompression-bomb limit (2 x 89,478,485 pixels,
// PIL's), refused before anything of its size is allocated.
Info info(const uint8_t* data, size_t size);

// Decode the first frame to RGB8 in rgb (height x width x 3, the canvas
// that info gave), as PIL's convert("RGB") gives it: libwebp's animation
// decoder's first canvas, zero outside the frame, with the alpha dropped.
// Throws as info does, and for a bitstream that libwebp refuses.
void decode(const uint8_t* data, size_t size, uint8_t* rgb, int width,
            int height);

}  // namespace mmst_webp
