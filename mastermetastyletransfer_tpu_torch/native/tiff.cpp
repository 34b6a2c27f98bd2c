// The TIFF codecs that run byte by byte, with no library beyond libstdc++:
// libtiff's LZW (tif_lzw.c) and PackBits (tif_packbits.c) decoders as
// Pillow's libtiff runs them, its JPEG codec's (tif_jpeg.c) framing of
// each strip or tile around native/jpeg.cpp, and the dispatch to the
// CCITT (native/fax.cpp) and Zstandard (native/zstd.cpp) decoders. utils/tiff.py parses the
// file, calls decode once for all the strips or tiles of an image (ctypes
// releases the interpreter lock), and undoes the predictor and the sample
// layout in numpy.
//
//   * LZW: codes of 9 to 12 bits, MSB-first, a clear code and an end code;
//     the code width grows one entry early (libtiff's "early change"); a
//     chunk whose first two bytes are 0x00 and an odd byte is the old
//     LSB-first form (LZWDecodeCompat: no early change). The string table
//     is libtiff's: entries of (value, first char, length, previous), a
//     code equal to the next free entry (KwKwK) takes its own first char,
//     a code past it or a table grown past libtiff's 5119 entries is a
//     corrupt table, the first code after a clear must be a literal, and
//     the stream must start with a clear code. The end of the chunk counts
//     as an end code; a string longer than the room left is cut.
//   * PackBits: -127..-1 repeats the next byte, 0..127 copies that many
//     bytes plus one, -128 is skipped; a run past the room left is cut, a
//     run past the data ends the chunk.
//   * JPEG: the JPEGTables stream (SOI, tables, EOI) is read before each
//     chunk's (SOI, frame, scans, EOI), which is how libjpeg takes an
//     abbreviated stream after a tables-only one. The frame must be the
//     segment's width and at least its height (more only for the last
//     strip, whose extra rows are dropped), as tif_jpeg.c checks; the
//     colours are libtiff's (YCbCr turned to RGB with JPEGCOLORMODE_RGB,
//     else the components as stored).
// In every codec, a chunk that ends before its bytes are whole is refused
// ("Not enough data"), as libtiff refuses it; with `tolerant` (libtiff's
// TIFFRGBAImage reading, which Pillow starts with stoponerr 0) a chunk
// that fails keeps what its codec wrote before failing and the next is
// decoded.

#include "tiff.h"

#include <algorithm>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "fax.h"
#include "jpeg.h"
#include "zstd.h"

namespace mmst_tiff {

namespace {

[[noreturn]] void fail(int i, const std::string& why) {
  throw std::runtime_error("TIFF: chunk " + std::to_string(i) + ": " + why);
}

constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kBitsMin = 9, kBitsMax = 12;
constexpr int kTableSize = (1 << kBitsMax) - 1 + 1024;   // libtiff's CSIZE

struct Entry {
  int next;   // the previous entry of the string, -1 for none
  int length;
  uint8_t value, firstchar;
};

// LZWDecode / LZWDecodeCompat on one chunk, to exactly `need` bytes.
void lzw(int i, const uint8_t* in, size_t n, uint8_t* op, int64_t need) {
  const bool old = n >= 2 && in[0] == 0 && (in[1] & 1);
  std::vector<Entry> tab(kTableSize);
  for (int c = 0; c < 256; ++c) tab[c] = {-1, 1, uint8_t(c), uint8_t(c)};
  for (int c = 256; c < kTableSize; ++c) tab[c] = {-1, 0, 0, 0};
  int nbits = kBitsMin;
  int nbitsmask = (1 << kBitsMin) - 1;
  // the entry after which the code width grows
  auto maxcode = [&](int mask) { return old ? mask : mask - 1; };
  int maxcodep = maxcode(nbitsmask);
  int free_ent = -1;   // no table before the first clear code
  int oldcode = -1;
  uint64_t bitsleft = uint64_t(n) * 8;
  uint64_t nextdata = 0;
  int nextbits = 0;
  size_t bp = 0;
  auto next_code = [&]() -> int {
    if (bitsleft < uint64_t(nbits)) return kEoi;   // "not terminated"
    int code;
    if (old) {
      nextdata |= uint64_t(in[bp++]) << nextbits;
      nextbits += 8;
      if (nextbits < nbits) {
        nextdata |= uint64_t(in[bp++]) << nextbits;
        nextbits += 8;
      }
      code = int(nextdata & uint64_t(nbitsmask));
      nextdata >>= nbits;
    } else {
      nextdata = (nextdata << 8) | in[bp++];
      nextbits += 8;
      if (nextbits < nbits) {
        nextdata = (nextdata << 8) | in[bp++];
        nextbits += 8;
      }
      code = int((nextdata >> (nextbits - nbits)) & uint64_t(nbitsmask));
    }
    nextbits -= nbits;
    bitsleft -= uint64_t(nbits);
    return code;
  };
  int64_t occ = need;
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int c = kFirst; c < kTableSize; ++c) tab[c] = {-1, 0, 0, 0};
        nbits = kBitsMin;
        nbitsmask = (1 << kBitsMin) - 1;
        maxcodep = maxcode(nbitsmask);
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) fail(i, "LZW: corrupted table");
      *op++ = uint8_t(code);
      occ--;
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kTableSize)
      fail(i, "LZW: corrupted table");
    Entry& e = tab[free_ent];
    e.next = oldcode;
    e.firstchar = tab[oldcode].firstchar;
    e.length = tab[oldcode].length + 1;
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxcodep) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      nbitsmask = (1 << nbits) - 1;
      maxcodep = maxcode(nbitsmask);
    }
    oldcode = code;
    if (code >= 256) {
      int k = code;
      if (tab[k].length == 0) fail(i, "LZW: wrong length of a decoded string");
      if (tab[k].length > occ) {   // the string's first occ bytes, and done
        do {
          k = tab[k].next;
        } while (k >= 0 && tab[k].length > occ);
        if (k >= 0) {
          uint8_t* tp = op + occ;
          do {
            *--tp = tab[k].value;
            k = tab[k].next;
          } while (--occ && k >= 0);
        }
        break;
      }
      const int len = tab[k].length;
      uint8_t* tp = op + len;
      do {
        *--tp = tab[k].value;
        k = tab[k].next;
      } while (k >= 0 && tp > op);
      if (k >= 0) break;   // a loop in the table: not enough data below
      op += len;
      occ -= len;
    } else {
      *op++ = uint8_t(code);
      occ--;
    }
  }
  if (occ > 0)
    fail(i, "LZW: not enough data (short " + std::to_string(occ) +
                " bytes)");
}

void packbits(int i, const uint8_t* in, size_t n, uint8_t* op, int64_t need) {
  const int8_t* bp = reinterpret_cast<const int8_t*>(in);
  int64_t cc = int64_t(n), occ = need;
  while (cc > 0 && occ > 0) {
    long k = *bp++;
    cc--;
    if (k < 0) {
      if (k == -128) continue;
      k = -k + 1;
      if (occ < k) k = long(occ);
      if (cc == 0) break;
      occ -= k;
      const uint8_t b = uint8_t(*bp++);
      cc--;
      std::memset(op, b, size_t(k));
      op += k;
    } else {
      if (occ < k + 1) k = long(occ) - 1;
      if (cc < k + 1) break;
      ++k;
      std::memcpy(op, bp, size_t(k));
      op += k;
      occ -= k;
      bp += k;
      cc -= k;
    }
  }
  if (occ > 0) fail(i, "PackBits: not enough data");
}

// tif_jpeg.c std_fill_input_buffer: past a stream's end libjpeg reads a
// fake EOI, again and again (a marker segment that runs past the end is
// read on into them), here enough of them for the longest segment.
std::vector<uint8_t> fake_eoi(const uint8_t* in, size_t n) {
  std::vector<uint8_t> s(in, in + n);
  s.resize(n + 65536 + 4);
  for (size_t j = n; j + 1 < s.size(); j += 2) {
    s[j] = 0xFF;
    s[j + 1] = 0xD9;
  }
  return s;
}

void jpeg(int i, const uint8_t* in, size_t n, int colour, int channels,
          int options, const Chunk& c, State& st, uint8_t* op) {
  // the tables libjpeg holds (JPEGTables first, then each strip's or
  // tile's own), read before the chunk's stream
  std::vector<uint8_t> stream;
  if (!st.jpeg_tables.empty()) {   // their segments, then the chunk's
    const std::vector<uint8_t> t =
        fake_eoi(st.jpeg_tables.data(), st.jpeg_tables.size());
    if (t[0] != 0xFF || t[1] != 0xD8)
      fail(i, "JPEG: JPEGTables does not start with SOI");
    stream.assign(t.begin(), t.begin() + 2);
    size_t pos = 2;
    for (;;) {   // jdmarker.c read_markers on the tables, to their EOI
      int m = 0;
      while (m == 0) {
        while (pos < t.size() && t[pos] != 0xFF) ++pos;
        do {
          ++pos;
        } while (pos < t.size() && t[pos] == 0xFF);
        if (pos >= t.size()) fail(i, "JPEG: JPEGTables has no end");
        m = t[pos++];
      }
      if (m == 0xD9) break;
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;   // no length
      if (pos + 2 > t.size()) fail(i, "JPEG: JPEGTables has no end");
      const size_t len = size_t(t[pos]) << 8 | t[pos + 1];
      if (len < 2 || pos + len > t.size())
        fail(i, "JPEG: a JPEGTables segment of a bad length");
      stream.push_back(0xFF);
      stream.push_back(uint8_t(m));
      stream.insert(stream.end(), t.begin() + pos, t.begin() + pos + len);
      pos += len;
    }
    if (n < 2 || in[0] != 0xFF || in[1] != 0xD8)
      fail(i, "JPEG: no SOI");
    stream.insert(stream.end(), in + 2, in + n);
    stream = fake_eoi(stream.data(), stream.size());
  } else {
    stream = fake_eoi(in, n);
  }
  in = stream.data();
  n = stream.size();
  const mmst_jpeg::Info f = mmst_jpeg::frame_info(in, n);
  // tif_jpeg.c JPEGPreDecode's checks
  const int comps = colour == mmst_jpeg::kColourYcc ? 3 : f.components;
  const bool planar = options & kJpegPlanar;
  if (!(f.width == c.width && f.height > c.height && c.last) &&
      (f.width > c.width || f.height > c.height))
    fail(i, "JPEG: a frame of " + std::to_string(f.width) + "x" +
                std::to_string(f.height) + " exceeds its segment of " +
                std::to_string(c.width) + "x" + std::to_string(c.height));
  if (f.components != (colour == mmst_jpeg::kColourYcc ? 3 : channels))
    fail(i, "JPEG: improper component count");
  if (!planar && st.jpeg_h == 0) {   // JPEGFixupTagsSubsampling
    st.jpeg_h = options & 15 ? options & 15 : f.h0;
    st.jpeg_v = (options >> 4) & 15 ? (options >> 4) & 15 : f.v0;
  }
  const int h = planar ? 1 : st.jpeg_h, v = planar ? 1 : st.jpeg_v;
  if (f.h0 != h || f.v0 != v || (!planar && !f.others_1x1))
    fail(i, "JPEG: improper sampling factors");
  // jpeg_read_scanlines: the frame's rows, as wide as the frame, into the
  // segment's rows; a smaller frame leaves the rest as the buffer held
  std::vector<uint8_t> px(size_t(f.width) * f.height * comps);
  st.jpeg_tables = mmst_jpeg::decode_tiff_chunk(in, n, px.data(), f.width,
                                                f.height, colour);
  const int rows = std::min(c.height, f.height);
  const int64_t rowbytes = c.height ? c.need / c.height : 0;
  const size_t width = std::min<size_t>(size_t(f.width) * comps,
                                        size_t(rowbytes));
  for (int r = 0; r < rows; ++r)
    std::memcpy(op + r * rowbytes, px.data() + size_t(r) * f.width * comps,
                width);
}

uint8_t reversed(uint8_t b) {
  b = uint8_t((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = uint8_t((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return uint8_t((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

}  // namespace

void decode_one(int compression, const uint8_t* data, size_t size,
                const Chunk& c, int i, int reverse, int colour, int channels,
                int options, State& st, uint8_t* out) {
  if (c.count == 0) fail(i, "a strip or tile of 0 bytes");
  if (c.offset > size || c.count > size - c.offset)
    fail(i, "read error: the strip or tile runs past the file");
  const uint8_t* in = data + c.offset;
  std::vector<uint8_t> flipped;
  if (reverse && compression != 7) {
    flipped.resize(c.count);
    for (uint64_t k = 0; k < c.count; ++k) flipped[k] = reversed(in[k]);
    in = flipped.data();
  }
  if (compression == 5) {
    lzw(i, in, c.count, out, c.need);
  } else if (compression == 32773) {
    packbits(i, in, c.count, out, c.need);
  } else if (compression == 7) {
    jpeg(i, in, c.count, colour, channels, options, c, st, out);
  } else if (compression == 2 || compression == 3 || compression == 4 ||
             compression == 32771) {
    try {
      mmst_fax::decode(compression, options, in, c.count, c.offset, c.width,
                       c.height, c.height ? c.need / c.height : 0, out,
                       st.fax);
    } catch (const std::runtime_error& e) {
      fail(i, e.what());
    }
  } else if (compression == 50000) {
    try {
      mmst_zstd::decode(in, c.count, out, size_t(c.need));
    } catch (const std::runtime_error& e) {
      fail(i, e.what());
    }
  } else {
    fail(i, "compression " + std::to_string(compression) +
                " is not a byte-serial codec");
  }
}

void decode(int compression, const uint8_t* data, size_t size,
            Chunk* chunks, int n, int reverse, int tolerant, int carry,
            const uint8_t* tables, size_t ntables, int colour, int channels,
            int options, State& st, uint8_t* out) {
  if (!st.jpeg_started) {   // libjpeg reads JPEGTables once, first
    st.jpeg_tables.assign(tables, tables + ntables);
    st.jpeg_started = true;
  }
  for (int i = 0; i < n; ++i) {
    if (carry && i > 0)
      std::memcpy(out, out - chunks[i - 1].need,
                  size_t(std::min(chunks[i].need, chunks[i - 1].need)));
    chunks[i].status = 0;
    try {
      decode_one(compression, data, size, chunks[i], i, reverse, colour,
                 channels, options, st, out);
    } catch (const std::runtime_error&) {
      chunks[i].status = 1;
      if (!tolerant) throw;
    }
    out += chunks[i].need;
  }
}

}  // namespace mmst_tiff

extern "C" {

int mmst_tiff_decode(int compression, const uint8_t* data, size_t size,
                     mmst_tiff::Chunk* chunks, int n, int reverse,
                     int tolerant, int carry, const uint8_t* tables,
                     size_t ntables, int colour, int channels, int options,
                     void* state, uint8_t* out, char* err, int errlen) {
  try {
    mmst_tiff::State local;
    mmst_tiff::decode(compression, data, size, chunks, n, reverse, tolerant,
                      carry, tables, ntables, colour, channels, options,
                      state ? *static_cast<mmst_tiff::State*>(state) : local,
                      out);
    return 0;
  } catch (const std::exception& e) {
    if (errlen > 0) {
      std::strncpy(err, e.what(), size_t(errlen) - 1);
      err[errlen - 1] = 0;
    }
    return 1;
  }
}

void* mmst_tiff_state_new() { return new mmst_tiff::State(); }

void mmst_tiff_state_free(void* state) {
  delete static_cast<mmst_tiff::State*>(state);
}

}  // extern "C"
