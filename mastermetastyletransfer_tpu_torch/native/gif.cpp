// GIF decoder, with no library beyond libstdc++.
//
// It gives what Pillow gives for the first frame (GifImagePlugin.py and
// libImaging/GifDecode.c), which PIL's convert("RGB") then looks up:
//   * the header: the logical screen and its global colour table; a table
//     that is the grey ramp (entry i = (i, i, i) throughout) is dropped, as
//     Pillow drops it, and the image is then grey ("L");
//   * the blocks before the first image descriptor: extensions skipped
//     sub-block by sub-block, the graphic control extension read for its
//     transparency index (which fills the canvas), a NETSCAPE application
//     extension's extra sub-block read as Pillow reads it; any other byte
//     skipped;
//   * the image descriptor: the frame's extent (a frame that reaches past
//     the screen grows the canvas; a frame of width 0 at x = 0 is decoded
//     over the whole canvas, as Pillow's setimage takes it), its local
//     colour table, interlacing, the LZW code size (0-12);
//   * the LZW data as GifDecode.c decodes it: sub-blocks taken whole,
//     LSB-first codes, clear and end codes, the code width grown at the
//     table's mask up to 12 bits, a code equal to the next free entry (the
//     KwKwK case), a full table kept (the deferred clear); the rows in
//     order or in the four interlaced passes; the decode ends when the
//     frame's last row is written. The data is fed in ImageFile.load's
//     64 KiB reads: an end code before the frame is whole ends a read, and
//     decoding goes on with the next one, so that a frame that is not
//     whole when the file ends is refused, as Pillow refuses it;
//   * the canvas outside the frame is the transparency index where the
//     frame has one, else 0, and the palette is black past its entries.

#include "gif.h"

#include <algorithm>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace mmst_gif {

namespace {

constexpr int64_t kMaxPixels = 2 * int64_t(89478485);
constexpr int kTable = 4096;   // GIFTABLE
constexpr int kBits = 12;      // GIFBITS
constexpr size_t kRead = 65536;   // ImageFile.MAXBLOCK

[[noreturn]] void fail(const std::string& why) {
  throw std::runtime_error("GIF: " + why);
}

int u16(const uint8_t* p) { return p[0] | p[1] << 8; }

// What GifImageFile._open and _seek(0) take from the file.
struct Header {
  int width = 0, height = 0;        // the canvas
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;   // the frame's extent
  bool interlace = false;
  int transparency = -1;            // the graphic control's index, or -1
  int bits = 0;                     // the LZW minimum code size
  size_t offset = 0;                // the LZW data
  bool grey = true;                 // mode "L": no colour table in use
  std::vector<uint8_t> palette;     // the frame's table (mode "P")
};

// A stream over the bytes with Python's read(n): short at the end.
struct Reader {
  const uint8_t* data;
  size_t size, pos = 0;
  size_t read(size_t n, const uint8_t** p) {
    *p = data + pos;
    const size_t got = std::min(n, size - pos);
    pos += got;
    return got;
  }
  int byte() {   // read(1)[0]; -1 at the end
    return pos < size ? data[pos++] : -1;
  }
  // GifImageFile.data(): a sub-block; false at a 0 size byte or the end.
  // The sub-block may be short (even empty) at the end of the file.
  bool block(const uint8_t** p, size_t* n) {
    const int s = byte();
    if (s <= 0) return false;
    *n = read(size_t(s), p);
    return true;
  }
};

// GifImageFile._is_palette_needed, with its IndexError: a table whose
// length is not a whole number of entries fails where the loop reaches
// the partial one.
bool palette_needed(const uint8_t* p, size_t n) {
  for (size_t i = 0; i < n; i += 3) {   // i // 3 == p[i] == p[i+1] == p[i+2]
    if (i / 3 != p[i]) return true;
    if (i + 1 >= n) fail("truncated colour table");
    if (p[i] != p[i + 1]) return true;
    if (i + 2 >= n) fail("truncated colour table");
    if (p[i + 1] != p[i + 2]) return true;
  }
  return false;
}

void check_size(int64_t w, int64_t h) {
  if (w * h > kMaxPixels)
    fail("a canvas of " + std::to_string(w) + "x" + std::to_string(h) +
         " pixels is above the limit of " + std::to_string(kMaxPixels) +
         " (a decompression bomb)");
}

Header parse(const uint8_t* data, size_t size) {
  if (size < 6 || (std::memcmp(data, "GIF87a", 6) != 0 &&
                   std::memcmp(data, "GIF89a", 6) != 0))
    fail("not a GIF file");
  if (size < 13) fail("truncated header");
  Header h;
  h.width = u16(data + 6);
  h.height = u16(data + 8);
  Reader r{data, size, 13};
  const int flags = data[10];
  bool have_global = false;
  std::vector<uint8_t> global;
  if (flags & 128) {
    const uint8_t* p;
    const size_t n = r.read(size_t(3) << ((flags & 7) + 1), &p);
    if (palette_needed(p, n)) {
      have_global = true;
      global.assign(p, p + n);
    }
  }
  int s = r.byte();
  if (s < 0 || s == ';') fail("no image in the file");
  int local = -1;   // -1 none, 0 a grey ramp (Pillow's False), 1 a table
  std::vector<uint8_t> local_table;
  bool found = false;
  for (;;) {
    if (s == -2) s = r.byte();
    if (s < 0 || s == ';') break;
    if (s == '!') {
      const int label = r.byte();
      if (label < 0) fail("truncated extension");
      const uint8_t* block;
      size_t n = 0;
      const bool have = r.block(&block, &n);
      if (label == 249 && have) {   // graphic control
        if (n < 1) fail("truncated graphic control extension");
        if (block[0] & 1) {
          if (n < 4) fail("truncated graphic control extension");
          h.transparency = block[3];
        }
        if (n < 3) fail("truncated graphic control extension");
      } else if (label == 254) {   // comment: its sub-blocks, then on
        bool more = have && n > 0;
        while (more) more = r.block(&block, &n) && n > 0;
        s = -2;
        continue;
      } else if (label == 255 && have && n >= 11 &&
                 std::memcmp(block, "NETSCAPE2.0", 11) == 0) {
        r.block(&block, &n);   // the loop count's sub-block, read apart
      }
      while (r.block(&block, &n) && n > 0) {
      }
    } else if (s == ',') {
      const uint8_t* d;
      if (r.read(9, &d) < 9) fail("truncated image descriptor");
      h.x0 = u16(d);
      h.y0 = u16(d + 2);
      h.x1 = h.x0 + u16(d + 4);
      h.y1 = h.y0 + u16(d + 6);
      if (h.x1 > h.width || h.y1 > h.height) {
        h.width = std::max(h.x1, h.width);
        h.height = std::max(h.y1, h.height);
        check_size(h.width, h.height);
      }
      const int lflags = d[8];
      h.interlace = (lflags & 64) != 0;
      if (lflags & 128) {
        const uint8_t* p;
        const size_t n = r.read(size_t(3) << ((lflags & 7) + 1), &p);
        local = palette_needed(p, n) ? 1 : 0;
        if (local) local_table.assign(p, p + n);
      }
      h.bits = r.byte();
      if (h.bits < 0) fail("truncated image descriptor");
      h.offset = r.pos;
      found = true;
      break;
    }
    s = -2;
  }
  if (!found) fail("image not found in GIF frame");
  check_size(h.width, h.height);
  if (h.width <= 0 || h.height <= 0)
    fail("a canvas of " + std::to_string(h.width) + "x" +
         std::to_string(h.height) + " pixels");
  if (local == 1) {
    h.grey = false;
    h.palette = std::move(local_table);
  } else if (local == -1 && have_global) {
    h.grey = false;
    h.palette = std::move(global);
  }
  return h;
}

// libImaging/GifDecode.c's state and its decode call, over one buffer.
struct Lzw {
  // the image: the canvas and the tile
  uint8_t* canvas;
  int stride;
  int xoff, yoff, xsize, ysize;
  // ImagingCodecState
  int state = 0, x = 0, y = 0, errcode = 0;
  // GIFDECODERSTATE
  int bits, interlace, step = 1, repeat = 0, clear = 0, end = 0, next = 0;
  int codesize = 0, codemask = 0, lastcode = 0, bufferindex = 0;
  int blocksize = 0, bitcount = 0;
  int32_t bitbuffer = 0;
  uint8_t lastdata = 0;
  uint8_t buffer[kTable];
  uint8_t data[kTable];
  uint16_t link[kTable];

  uint8_t* row() { return canvas + size_t(y + yoff) * stride + xoff; }

  // The NEWLINE macro: false where the frame is whole (Pillow's return -1).
  bool newline(uint8_t** out) {
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (interlace) {
        case 1:
          repeat = y = 4;
          interlace = 2;
          break;
        case 2:
          step = 4;
          repeat = y = 2;
          interlace = 3;
          break;
        case 3:
          step = 2;
          repeat = y = 1;
          interlace = 0;
          break;
        default:
          return false;
      }
    }
    if (y < ysize) *out = row() + 0;
    return true;
  }

  // ImagingGifDecode: the bytes consumed, or -1 (done, or errcode < 0).
  int64_t decode(const uint8_t* buf, int64_t bytes) {
    const uint8_t* ptr = buf;
    if (!state) {
      if (bits < 0 || bits > 12) {
        errcode = -8;   // IMAGING_CODEC_CONFIG
        return -1;
      }
      clear = 1 << bits;
      end = clear + 1;
      if (interlace) {
        interlace = 1;
        step = repeat = 8;
      } else {
        step = 1;
      }
      state = 1;
    }
    uint8_t* out = row() + x;
    for (;;) {
      if (state == 1) {
        next = clear + 2;
        codesize = bits + 1;
        codemask = (1 << codesize) - 1;
        bufferindex = kTable;
        state = 2;
      }
      const uint8_t* p;
      int i;
      if (bufferindex < kTable) {
        i = kTable - bufferindex;
        p = &buffer[bufferindex];
        bufferindex = kTable;
      } else {
        while (bitcount < codesize) {
          if (blocksize > 0) {
            const int c = *ptr++;
            bytes--;
            blocksize--;
            bitbuffer |= int32_t(c) << bitcount;
            bitcount += 8;
          } else {
            if (bytes < 1) return ptr - buf;
            const int c = *ptr;
            if (bytes < c + 1) return ptr - buf;
            blocksize = c;
            ptr++;
            bytes--;
          }
        }
        int c = int(bitbuffer) & codemask;
        bitbuffer >>= codesize;
        bitcount -= codesize;
        if (c == clear) {
          if (state != 2) state = 1;
          continue;
        }
        if (c == end) break;
        i = 1;
        p = &lastdata;
        if (state == 2) {
          if (c > clear) {
            errcode = -2;   // IMAGING_CODEC_BROKEN
            return -1;
          }
          lastdata = uint8_t(c);
          lastcode = c;
          state = 3;
        } else {
          const int thiscode = c;
          if (c > next) {
            errcode = -2;
            return -1;
          }
          if (c == next) {
            if (bufferindex <= 0) {
              errcode = -2;
              return -1;
            }
            buffer[--bufferindex] = lastdata;
            c = lastcode;
          }
          while (c >= clear) {
            if (bufferindex <= 0 || c >= kTable) {
              errcode = -2;
              return -1;
            }
            buffer[--bufferindex] = data[c];
            c = link[c];
          }
          lastdata = uint8_t(c);
          if (next < kTable) {
            data[next] = uint8_t(c);
            link[next] = uint16_t(lastcode);
            if (next == codemask && codesize < kBits) {
              codesize++;
              codemask = (1 << codesize) - 1;
            }
            next++;
          }
          lastcode = thiscode;
        }
      }
      if (y >= ysize) {
        errcode = -1;   // IMAGING_CODEC_OVERRUN
        return -1;
      }
      // transparency is -1 for the first frame: every index is written
      if (i == 1) {
        if (x < xsize - 1) {
          *out++ = p[0];
          x++;
          continue;
        }
      } else if (x + i <= xsize) {
        std::memcpy(out, p, size_t(i));
        out += i;
        x += i;
        if (x == xsize && !newline(&out)) return -1;
        continue;
      }
      for (int k = 0; k < i; k++) {
        *out++ = p[k];
        if (++x >= xsize) {
          if (!newline(&out)) return -1;
          if (y >= ysize) break;
        }
      }
    }
    return ptr - buf;
  }
};

}  // namespace

Info info(const uint8_t* data, size_t size) {
  const Header h = parse(data, size);
  return {h.width, h.height};
}

void decode(const uint8_t* data, size_t size, uint8_t* rgb, int width,
            int height) {
  const Header h = parse(data, size);
  if (h.width != width || h.height != height)
    fail("the canvas is not the one info gave");
  std::vector<uint8_t> canvas(size_t(width) * height,
                              uint8_t(h.transparency < 0 ? 0 : h.transparency));
  Lzw lzw{};
  lzw.canvas = canvas.data();
  lzw.stride = width;
  lzw.bits = h.bits;
  lzw.interlace = h.interlace;
  // decode.c _setimage: an extent from x 0 to x 0 is the whole image
  if (h.x0 == 0 && h.x1 == 0) {
    lzw.xoff = lzw.yoff = 0;
    lzw.xsize = width;
    lzw.ysize = height;
  } else {
    lzw.xoff = h.x0;
    lzw.yoff = h.y0;
    lzw.xsize = h.x1 - h.x0;
    lzw.ysize = h.y1 - h.y0;
  }
  if (lzw.xsize <= 0 || lzw.ysize <= 0 || lzw.xoff + lzw.xsize > width ||
      lzw.yoff + lzw.ysize > height)
    fail("tile cannot extend outside image");
  // ImageFile.load: 64 KiB reads appended to what the decoder left
  const uint8_t* stream = data + h.offset;
  const size_t total = size - h.offset;
  size_t have = 0, start = 0;
  for (;;) {
    if (have == total) fail("image file is truncated");
    have = std::min(total, have + kRead);
    const int64_t n = lzw.decode(stream + start, int64_t(have - start));
    if (n < 0) break;
    start += size_t(n);
  }
  if (lzw.errcode < 0) fail("decoder error " + std::to_string(lzw.errcode));
  uint8_t table[256][3] = {};
  if (h.grey) {
    for (int i = 0; i < 256; i++)
      table[i][0] = table[i][1] = table[i][2] = uint8_t(i);
  } else {
    const size_t n = std::min<size_t>(h.palette.size() / 3, 256);
    std::memcpy(table, h.palette.data(), n * 3);
  }
  const size_t count = canvas.size();
  for (size_t i = 0; i < count; i++)
    std::memcpy(rgb + 3 * i, table[canvas[i]], 3);
}

}  // namespace mmst_gif

extern "C" {

static int mmst_gif_error(const std::exception& e, char* err, int errlen) {
  if (errlen > 0) {
    std::strncpy(err, e.what(), size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
  return 1;
}

int mmst_gif_info(const uint8_t* data, size_t size, int* width, int* height,
                  char* err, int errlen) {
  try {
    const mmst_gif::Info info = mmst_gif::info(data, size);
    *width = info.width;
    *height = info.height;
    return 0;
  } catch (const std::exception& e) {
    return mmst_gif_error(e, err, errlen);
  }
}

int mmst_gif_decode(const uint8_t* data, size_t size, uint8_t* rgb,
                    int width, int height, char* err, int errlen) {
  try {
    mmst_gif::decode(data, size, rgb, width, height);
    return 0;
  } catch (const std::exception& e) {
    return mmst_gif_error(e, err, errlen);
  }
}

}  // extern "C"
