// GIF decoder of the port's own (native/gif.cpp), bound by
// data/native_loader.py with ctypes. No library beyond libstdc++.

#pragma once

#include <cstddef>
#include <cstdint>

namespace mmst_gif {

// The canvas of a GIF's first frame: the logical screen, grown to hold the
// frame where the frame reaches past it, as Pillow grows it.
struct Info {
  int width, height;
};

// Read the header, the colour tables and the blocks up to the first image
// descriptor as Pillow's GifImagePlugin reads them, and give the canvas.
// Throws std::runtime_error naming what is wrong: a truncated or corrupt
// header, no image, or a canvas above the decompression-bomb limit
// (2 x 89,478,485 pixels, PIL's), refused before anything of its size is
// allocated.
Info info(const uint8_t* data, size_t size);

// Decode the first frame to RGB8 in rgb (height x width x 3, the canvas
// that info gave), as PIL's convert("RGB") gives it. Throws as info does,
// and where Pillow's LZW decoder fails or the data ends before the frame
// is whole.
void decode(const uint8_t* data, size_t size, uint8_t* rgb, int width,
            int height);

}  // namespace mmst_gif
