// A Zstandard decoder written from RFC 8878 for the port's TIFF reader,
// with libzstd's checks and the order in which its streaming decoder
// (ZSTD_decompressStream, as libtiff's tif_zstd.c calls it) meets them:
//
//   * the frame header: the magic number (a skippable frame ends the call
//     with nothing written), the reserved bit, a dictionary ID (no
//     dictionary is loaded, so any is refused), the window (above 2^27,
//     libzstd's default limit for a decoder, refused before anything of
//     its size exists; no window buffer is kept here at all: the output is
//     the history), the content size;
//   * where the content size is known, fits the room left and the whole
//     frame lies in the data, libzstd decodes the frame in one pass: its
//     errors and its checksum are all checked;
//   * otherwise block by block: a block header, then the block (a raw
//     block's bytes may arrive in part), each decoded block flushed into
//     the room left; once the room is full the decoder stops, except that
//     a block flushed whole lets libzstd read on to the next block header
//     and block (or the checksum), whose errors then count;
//   * blocks: raw, RLE and compressed, none decoding to more than
//     min(window, 128 KiB); literals raw, RLE, or Huffman-coded in one or
//     four streams (the weights direct or FSE-coded; a treeless block
//     reusing the last table of the frame); sequences with predefined,
//     RLE, FSE-coded or repeated tables, three repeat offsets, each
//     bitstream read to its exact end;
//   * the content checksum: XXH64's low 32 bits.

#include "zstd.h"

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace mmst_zstd {

namespace {

[[noreturn]] void fail(const std::string& why) {
  throw std::runtime_error("ZSTD: " + why);
}

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr size_t kBlockMax = 128 * 1024;
constexpr uint64_t kWindowMax = uint64_t(1) << 27;
constexpr uint64_t kUnknown = ~uint64_t(0);

uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}
uint64_t le64(const uint8_t* p) {
  return uint64_t(le32(p)) | uint64_t(le32(p + 4)) << 32;
}
int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// XXH64, seed 0
struct Xxh64 {
  static constexpr uint64_t P1 = 11400714785074694791ull;
  static constexpr uint64_t P2 = 14029467366897019727ull;
  static constexpr uint64_t P3 = 1609587929392839161ull;
  static constexpr uint64_t P4 = 9650029242287828579ull;
  static constexpr uint64_t P5 = 2870177450012600261ull;
  uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
  uint64_t total = 0;
  uint8_t mem[32];
  size_t memsize = 0;

  static uint64_t rotl(uint64_t x, int r) { return x << r | x >> (64 - r); }
  static uint64_t round(uint64_t acc, uint64_t in) {
    acc += in * P2;
    acc = rotl(acc, 31);
    return acc * P1;
  }
  static uint64_t merge(uint64_t acc, uint64_t val) {
    acc ^= round(0, val);
    return acc * P1 + P4;
  }
  void stripe(const uint8_t* p) {
    for (int k = 0; k < 4; ++k) v[k] = round(v[k], le64(p + 8 * k));
  }
  void update(const uint8_t* p, size_t n) {
    total += n;
    if (memsize + n < 32) {
      std::memcpy(mem + memsize, p, n);
      memsize += n;
      return;
    }
    if (memsize) {
      const size_t take = 32 - memsize;
      std::memcpy(mem + memsize, p, take);
      stripe(mem);
      p += take;
      n -= take;
      memsize = 0;
    }
    for (; n >= 32; p += 32, n -= 32) stripe(p);
    std::memcpy(mem, p, n);
    memsize = n;
  }
  uint64_t digest() const {
    uint64_t h;
    if (total >= 32) {
      h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
      for (int k = 0; k < 4; ++k) h = merge(h, v[k]);
    } else {
      h = v[2] + P5;
    }
    h += total;
    const uint8_t* p = mem;
    size_t n = memsize;
    for (; n >= 8; p += 8, n -= 8) {
      h ^= round(0, le64(p));
      h = rotl(h, 27) * P1 + P4;
    }
    if (n >= 4) {
      h ^= uint64_t(le32(p)) * P1;
      h = rotl(h, 23) * P2 + P3;
      p += 4;
      n -= 4;
    }
    for (; n; ++p, --n) {
      h ^= uint64_t(*p) * P5;
      h = rotl(h, 11) * P1;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
  }
};

// A bitstream read backwards from its last byte, whose highest set bit
// marks the start (BIT_DStream_t). Reading past the first byte gives
// zeros and is seen by `exact_end`.
struct BackBits {
  const uint8_t* start;
  int64_t pos;   // bits left to read
  BackBits(const uint8_t* p, size_t n) : start(p) {
    if (n < 1) fail("an empty bitstream");
    const uint8_t last = p[n - 1];
    if (last == 0) fail("a bitstream without its end mark");
    pos = int64_t(n) * 8 - 8 + highbit(last);
  }
  uint64_t read(int nb) {
    if (nb == 0) return 0;
    uint64_t v = 0;
    for (int k = 0; k < nb; ++k) {
      const int64_t b = pos - 1 - k;
      const int bit = b >= 0 ? (start[b >> 3] >> (b & 7)) & 1 : 0;
      v = v << 1 | uint64_t(bit);
    }
    pos -= nb;
    return v;
  }
  bool exact_end() const { return pos == 0; }
};

// FSE_readNCount, as libzstd reads a table description (reading the last
// four bytes again where it runs to the end): the normalized counts, the
// accuracy log, the bytes it took
size_t read_ncount(const uint8_t* src, size_t n, int max_symbol,
                   std::vector<int16_t>& norm, int& table_log,
                   int& last_symbol) {
  if (n < 8) {
    uint8_t buf[8] = {0};
    std::memcpy(buf, src, n);
    const size_t used = read_ncount(buf, 8, max_symbol, norm, table_log,
                                    last_symbol);
    if (used > n) fail("a table description past its data");
    return used;
  }
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  norm.assign(size_t(max_symbol) + 1, 0);
  uint32_t bits = le32(ip);
  int nbBits = int(bits & 0xF) + 5;
  if (nbBits > 15) fail("a table's accuracy log is too large");
  bits >>= 4;
  int bitCount = 4;
  table_log = nbBits;
  int remaining = (1 << nbBits) + 1;
  int threshold = 1 << nbBits;
  nbBits++;
  unsigned charnum = 0;
  const unsigned maxSV1 = unsigned(max_symbol) + 1;
  bool previous0 = false;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (bitCount >> 3) <= iend - 4) {
      ip += bitCount >> 3;
      bitCount &= 7;
    } else {
      bitCount -= int(8 * (iend - 4 - ip));
      bitCount &= 31;
      ip = iend - 4;
    }
    bits = le32(ip) >> bitCount;
  };
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          bitCount -= int(8 * (iend - 7 - ip));
          bitCount &= 31;
          ip = iend - 4;
        }
        bits = le32(ip) >> bitCount;
        repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      }
      charnum += 3 * unsigned(repeats);
      bits >>= 2 * repeats;
      bitCount += 2 * repeats;
      charnum += bits & 3;
      bitCount += 2;
      if (charnum >= maxSV1) break;
      advance();
    }
    {
      const int max = (2 * threshold - 1) - remaining;
      int count;
      if (int(bits & uint32_t(threshold - 1)) < max) {
        count = int(bits & uint32_t(threshold - 1));
        bitCount += nbBits - 1;
      } else {
        count = int(bits & uint32_t(2 * threshold - 1));
        if (count >= threshold) count -= max;
        bitCount += nbBits;
      }
      count--;
      if (count >= 0) {
        remaining -= count;
      } else {
        remaining += count;
      }
      norm[charnum++] = int16_t(count);
      previous0 = count == 0;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nbBits = highbit(uint32_t(remaining)) + 1;
        threshold = 1 << (nbBits - 1);
      }
      if (charnum >= maxSV1) break;
      advance();
    }
  }
  if (remaining != 1) fail("a table description's counts do not add up");
  if (charnum > maxSV1) fail("a table description of too many symbols");
  if (bitCount > 32) fail("a table description past its data");
  last_symbol = int(charnum) - 1;
  ip += (bitCount + 7) >> 3;
  return size_t(ip - src);
}

struct FseEntry {
  uint16_t symbol;
  uint8_t nbBits;
  uint16_t newState;
};

// The decoding table of normalized counts (ZSTD_buildFSETable)
std::vector<FseEntry> build_fse(const std::vector<int16_t>& norm,
                                int last_symbol, int table_log) {
  const int size = 1 << table_log;
  std::vector<FseEntry> t(static_cast<size_t>(size));
  std::vector<uint32_t> next(size_t(last_symbol) + 1);
  int high = size - 1;
  for (int s = 0; s <= last_symbol; ++s) {
    if (norm[s] == -1) {
      t[size_t(high--)].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int pos = 0;
  for (int s = 0; s <= last_symbol; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t[size_t(pos)].symbol = uint16_t(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) fail("an FSE table that does not fill");
  for (int u = 0; u < size; ++u) {
    const uint16_t s = t[size_t(u)].symbol;
    const uint32_t ns = next[s]++;
    const int nb = table_log - highbit(ns);
    t[size_t(u)].nbBits = uint8_t(nb);
    t[size_t(u)].newState = uint16_t((ns << nb) - uint32_t(size));
  }
  return t;
}

struct Fse {
  std::vector<FseEntry> table;
  int log = 0;
};

constexpr int kFastLog = 11;   // HUF_DECODER_FAST_TABLELOG

// A Huffman decoding table: (symbol, bits) for each `log`-bit prefix
struct Huffman {
  std::vector<uint8_t> symbol, bits;
  int log = 0;
};

// HUF_readStats + HUF_readDTableX1: the tree description at src (n bytes
// left in the block); returns the bytes it took
size_t read_huffman(const uint8_t* src, size_t n, Huffman& h) {
  if (n < 1) fail("no Huffman tree description");
  uint8_t weights[256] = {0};
  int count;
  size_t used;
  const int header = src[0];
  if (header >= 128) {
    count = header - 127;
    used = 1 + size_t((count + 1) / 2);
    if (used > n) fail("a Huffman tree description past its data");
    for (int i = 0; i < count; ++i)
      weights[i] = uint8_t(i & 1 ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4);
  } else {
    if (size_t(header) + 1 > n) fail("a Huffman tree description past "
                                     "its data");
    // FSE_decompress_wksp, accuracy log at most 6, two interleaved states
    std::vector<int16_t> norm;
    int tlog, last;
    const size_t hsize = read_ncount(src + 1, size_t(header), 255, norm,
                                     tlog, last);
    if (tlog > 6) fail("Huffman weights of too large an accuracy log");
    const std::vector<FseEntry> t = build_fse(norm, last, tlog);
    if (hsize >= size_t(header)) fail("no Huffman weights");
    BackBits bs(src + 1 + hsize, size_t(header) - hsize);
    uint32_t s1 = uint32_t(bs.read(tlog)), s2 = uint32_t(bs.read(tlog));
    count = 0;
    for (;;) {
      if (count > 253) fail("too many Huffman weights");
      weights[count++] = uint8_t(t[s1].symbol);
      s1 = t[s1].newState + uint32_t(bs.read(t[s1].nbBits));
      if (bs.pos < 0) {
        weights[count++] = uint8_t(t[s2].symbol);
        break;
      }
      if (count > 253) fail("too many Huffman weights");
      weights[count++] = uint8_t(t[s2].symbol);
      s2 = t[s2].newState + uint32_t(bs.read(t[s2].nbBits));
      if (bs.pos < 0) {
        weights[count++] = uint8_t(t[s1].symbol);
        break;
      }
    }
    used = 1 + size_t(header);
  }
  uint32_t rank[16] = {0};
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (weights[i] > 12) fail("a Huffman weight above 12");
    rank[weights[i]]++;
    total += (1u << weights[i]) >> 1;
  }
  if (total == 0) fail("Huffman weights of zero");
  const int log = highbit(total) + 1;
  if (log > 12) fail("a Huffman table above 12 bits");
  const uint32_t rest = (1u << log) - total;
  const uint32_t lastw = uint32_t(highbit(rest)) + 1;
  if ((1u << highbit(rest)) != rest) fail("Huffman weights that do not add up");
  weights[count++] = uint8_t(lastw);
  rank[lastw]++;
  if (rank[1] < 2 || (rank[1] & 1)) fail("Huffman weights that do not add up");
  // HUF_readDTableX1: the table has (at least) 11 index bits, libzstd's
  // fast table log, every weight raised to match (HUF_rescaleStats)
  const int dtlog = log < kFastLog ? kFastLog : log;
  const int scale = dtlog - log;
  h.log = dtlog;
  h.symbol.assign(size_t(1) << dtlog, 0);
  h.bits.assign(size_t(1) << dtlog, 0);
  // symbols of a weight in order, the lightest (longest codes) first
  uint32_t start = 0;
  for (int w = 1; w <= log; ++w) {
    const uint32_t len = (1u << (w + scale)) >> 1;
    for (int s = 0; s < count; ++s) {
      if (weights[s] != w) continue;
      for (uint32_t k = 0; k < len; ++k) {
        h.symbol[start + k] = uint8_t(s);
        h.bits[start + k] = uint8_t(log + 1 - w);
      }
      start += len;
    }
  }
  return used;
}

// libzstd's BIT_DStream_t on 64-bit little-endian: a container loaded
// from `ptr` (8 bytes), its bits read from the top; past `start` it
// stops reloading ("overflow", the container then points at zeros)
struct BitD {
  uint64_t container = 0;
  unsigned consumed = 0;
  const uint8_t* ptr = nullptr;
  const uint8_t* start = nullptr;
  const uint8_t* limit = nullptr;
  bool overflow = false;

  static uint64_t read64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
  }
  // BIT_initDStream; false for libzstd's error (no data, no end mark)
  bool init(const uint8_t* src, size_t n) {
    if (n < 1) return false;
    start = src;
    limit = start + 8;
    const uint8_t last = src[n - 1];
    if (n >= 8) {
      ptr = src + n - 8;
      container = read64(ptr);
      consumed = last ? 8 - unsigned(highbit(last)) : 0;
      return last != 0;
    }
    ptr = start;
    container = src[0];
    for (size_t k = 1; k < n; ++k) container += uint64_t(src[k]) << (8 * k);
    consumed = last ? 8 - unsigned(highbit(last)) : 0;
    consumed += unsigned(8 - n) * 8;
    return last != 0;
  }
  // BIT_lookBitsFast
  uint64_t look(int nb) const {
    return (container << (consumed & 63)) >> ((64 - nb) & 63);
  }
  void skip(int nb) { consumed += unsigned(nb); }
  enum { kUnfinished, kEndOfBuffer, kCompleted, kOverflow };
  // BIT_reloadDStream
  int reload() {
    if (consumed > 64) {
      overflow = true;
      return kOverflow;
    }
    if (ptr >= limit) {
      ptr -= consumed >> 3;
      consumed &= 7;
      container = read64(ptr);
      return kUnfinished;
    }
    if (ptr == start) return consumed < 64 ? kEndOfBuffer : kCompleted;
    unsigned bytes = consumed >> 3;
    int result = kUnfinished;
    if (ptr - bytes < start) {
      bytes = unsigned(ptr - start);
      result = kEndOfBuffer;
    }
    ptr -= bytes;
    consumed -= bytes * 8;
    container = read64(ptr);
    return result;
  }
  // BIT_endOfDStream
  bool end() const { return !overflow && ptr == start && consumed == 64; }
};

uint8_t huf_symbol(const Huffman& h, BitD& b) {
  const uint64_t v = b.look(h.log);
  b.skip(h.bits[v]);
  return h.symbol[v];
}

// HUF_decodeStreamX1: fills [p, end) whatever the bits hold
void huf_stream_x1(uint8_t* p, BitD& b, uint8_t* end, const Huffman& h) {
  if (end - p > 3) {
    while ((b.reload() == BitD::kUnfinished) & (p < end - 3)) {
      for (int k = 0; k < 4; ++k) *p++ = huf_symbol(h, b);
    }
  } else {
    b.reload();
  }
  while (p < end) *p++ = huf_symbol(h, b);
}

// One stream (HUF_decompress1X1): read to its exact end
void huffman_1x(const Huffman& h, const uint8_t* src, size_t n, uint8_t* out,
                size_t count) {
  BitD b;
  if (!b.init(src, n)) fail("a Huffman stream without its end mark");
  huf_stream_x1(out, b, out + count, h);
  if (!b.end()) fail("a Huffman stream not read to its end");
}

// Four streams (HUF_decompress4X1_usingDTable_internal on a 64-bit CPU
// with BMI2): libzstd's fast loop where every stream has 8 bytes and the
// table 11 bits; it checks only that no stream read more than 8 bytes
// below its own start (the streams finish reading down to the first's);
// otherwise the default body, each stream read to its exact end.
void huffman_4x(const Huffman& h, const uint8_t* src, size_t n, uint8_t* out,
                size_t count) {
  if (n < 10) fail("four Huffman streams in too few bytes");
  const size_t l1 = src[0] | size_t(src[1]) << 8;
  const size_t l2 = src[2] | size_t(src[3]) << 8;
  const size_t l3 = src[4] | size_t(src[5]) << 8;
  if (l1 + l2 + l3 + 6 > n) fail("Huffman streams past the block");
  const size_t l4 = n - (l1 + l2 + l3 + 6);
  const size_t seg = (count + 3) / 4;
  uint8_t* const oend = out + count;
  if (seg * 3 > count) fail("four Huffman streams of too few literals");
  const uint8_t* iend[4] = {src + 6, src + 6 + l1, src + 6 + l1 + l2,
                            src + 6 + l1 + l2 + l3};
  const size_t len[4] = {l1, l2, l3, l4};
  uint8_t* opstart[4] = {out, out + seg, out + 2 * seg, out + 3 * seg};
  const bool fast = h.log == kFastLog && l1 >= 8 && l2 >= 8 && l3 >= 8 &&
                    l4 >= 8 && opstart[3] < oend;
  if (!fast) {
    BitD b[4];
    for (int i = 0; i < 4; ++i)
      if (!b[i].init(iend[i], len[i]))
        fail("a Huffman stream without its end mark");
    for (int i = 0; i < 4; ++i)
      huf_stream_x1(opstart[i], b[i], i < 3 ? opstart[i + 1] : oend, h);
    for (int i = 0; i < 4; ++i)
      if (!b[i].end()) fail("a Huffman stream not read to its end");
    return;
  }
  // HUF_DecompressFastArgs_init and the C fast loop
  const uint8_t* const ilowest = src;
  const uint8_t* ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8,
                          src + n - 8};
  uint8_t* op[4] = {opstart[0], opstart[1], opstart[2], opstart[3]};
  uint64_t bits[4];
  for (int i = 0; i < 4; ++i) {
    const uint8_t last = ip[i][7];
    const int used = last ? 8 - highbit(last) : 0;
    bits[i] = (BitD::read64(ip[i]) | 1) << used;
  }
  const int shift = 64 - kFastLog;
  for (;;) {
    const size_t oiters = size_t(oend - op[3]) / 5;
    const size_t iiters = size_t(ip[0] - ilowest) / 7;
    uint8_t* const olimit = op[3] + std::min(oiters, iiters) * 5;
    if (op[3] == olimit) break;
    bool crossed = false;
    for (int i = 1; i < 4; ++i)
      if (ip[i] < ip[i - 1]) crossed = true;
    if (crossed) break;
    do {
      for (int k = 0; k < 5; ++k) {
        for (int i = 0; i < 4; ++i) {
          const uint64_t index = bits[i] >> shift;
          bits[i] <<= h.bits[index];
          op[i][k] = h.symbol[index];
        }
      }
      for (int i = 0; i < 4; ++i) {
        const int ctz = __builtin_ctzll(bits[i]);
        op[i] += 5;
        ip[i] -= ctz >> 3;
        bits[i] = (BitD::read64(ip[i]) | 1) << (ctz & 7);
      }
    } while (op[3] < olimit);
  }
  for (int i = 0; i < 4; ++i) {   // HUF_initRemainingDStream, then finish
    uint8_t* const segend = i < 3 ? opstart[i + 1] : oend;
    if (op[i] > segend) fail("a Huffman stream past its segment");
    if (ip[i] < iend[i] - 8) fail("a Huffman stream read below its start");
    BitD b;
    b.container = BitD::read64(ip[i]);
    b.consumed = unsigned(__builtin_ctzll(bits[i]));
    b.start = ilowest;
    b.limit = ilowest + 8;
    b.ptr = ip[i];
    huf_stream_x1(op[i], b, segend, h);
  }
}

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
    16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
    16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

Fse default_fse(const int16_t* d, int count, int log) {
  return {build_fse(std::vector<int16_t>(d, d + count), count - 1, log),
          log};
}

// One frame's decoder: the entropy it carries from block to block, the
// output (the whole history: offsets reach back into it)
struct Frame {
  Huffman huf;
  bool have_huf = false;
  Fse ll, of, ml;
  bool have_seq = false;
  uint64_t rep[3] = {1, 4, 8};
  size_t block_max = kBlockMax;
  std::vector<uint8_t>& out;
  explicit Frame(std::vector<uint8_t>& o) : out(o) {}

  // ZSTD_decodeLiteralsBlock: the block's literals
  size_t literals(const uint8_t* src, size_t n, std::vector<uint8_t>& lit) {
    if (n < 2) fail("a compressed block of less than 2 bytes");
    const int type = src[0] & 3, sf = (src[0] >> 2) & 3;
    if (type < 2) {
      size_t lh, size;
      if (sf == 0 || sf == 2) {
        lh = 1;
        size = src[0] >> 3;
      } else if (sf == 1) {
        lh = 2;
        size = (src[0] >> 4) + (size_t(src[1]) << 4);
      } else {
        if (n < 3) fail("a literals header past the block");
        lh = 3;
        size = (src[0] >> 4) + (size_t(src[1]) << 4) +
               (size_t(src[2]) << 12);
      }
      if (size > block_max) fail("literals above the block size");
      if (type == 0) {
        if (lh + size > n) fail("raw literals past the block");
        lit.assign(src + lh, src + lh + size);
        return lh + size;
      }
      if (lh + 1 > n) fail("RLE literals past the block");
      lit.assign(size, src[lh]);
      return lh + 1;
    }
    if (n < 5) fail("a literals header past the block");
    size_t lh, regen, csize;
    bool single = false;
    const uint32_t v = le32(src);
    if (sf < 2) {
      single = sf == 0;
      lh = 3;
      regen = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
    } else if (sf == 2) {
      lh = 4;
      regen = (v >> 4) & 0x3FFF;
      csize = v >> 18;
    } else {
      lh = 5;
      regen = (v >> 4) & 0x3FFFF;
      csize = (v >> 22) + (size_t(src[4]) << 10);
    }
    if (regen > block_max) fail("literals above the block size");
    if (csize + lh > n) fail("compressed literals past the block");
    if (!single && regen < 6) fail("too few literals for four streams");
    const uint8_t* p = src + lh;
    size_t left = csize;
    if (type == 2) {
      const size_t used = read_huffman(p, left, huf);
      p += used;
      left -= used;
      have_huf = true;
    } else if (!have_huf) {
      fail("treeless literals before any Huffman table");
    }
    lit.assign(regen, 0);
    if (single) {
      huffman_1x(huf, p, left, lit.data(), regen);
    } else {
      huffman_4x(huf, p, left, lit.data(), regen);
    }
    return lh + csize;
  }

  // ZSTD_buildSeqTable for one of the three codes
  size_t seq_table(int mode, const uint8_t* src, size_t n, Fse& table,
                   int max_symbol, int max_log, const int16_t* def,
                   int def_count, int def_log) {
    if (mode == 0) {
      table = default_fse(def, def_count, def_log);
      return 0;
    }
    if (mode == 1) {
      if (n < 1) fail("an RLE sequence code past the block");
      if (src[0] > max_symbol) fail("an RLE sequence code out of range");
      table.log = 0;
      table.table.assign(1, FseEntry{src[0], 0, 0});
      return 1;
    }
    if (mode == 2) {
      std::vector<int16_t> norm;
      int log, last;
      const size_t used = read_ncount(src, n, max_symbol, norm, log, last);
      if (log > max_log) fail("a sequence table of too large an accuracy "
                              "log");
      table.table = build_fse(norm, last, log);
      table.log = log;
      return used;
    }
    if (!have_seq) fail("a repeated sequence table before any table");
    return 0;
  }

  void block(const uint8_t* src, size_t n) {
    std::vector<uint8_t> lit;
    size_t used = literals(src, n, lit);
    const uint8_t* ip = src + used;
    const uint8_t* const iend = src + n;
    if (ip >= iend) fail("no sequences section");
    size_t nbSeq = *ip++;
    if (nbSeq >= 128) {
      if (nbSeq == 255) {
        if (ip + 2 > iend) fail("a sequences header past the block");
        nbSeq = ip[0] + (size_t(ip[1]) << 8) + 0x7F00;
        ip += 2;
      } else {
        if (ip >= iend) fail("a sequences header past the block");
        nbSeq = ((nbSeq - 128) << 8) + *ip++;
      }
    }
    const size_t base = out.size();
    if (nbSeq == 0) {
      if (ip != iend) fail("data after a block of no sequences");
      if (lit.size() > block_max) fail("a block above its maximum size");
      out.insert(out.end(), lit.begin(), lit.end());
      return;
    }
    if (ip >= iend) fail("no sequence code modes");
    const int modes = *ip++;
    if (modes & 3) fail("reserved bits of the sequence code modes");
    ip += seq_table(modes >> 6, ip, size_t(iend - ip), ll, 35, 9,
                    kLLDefault, 36, 6);
    ip += seq_table((modes >> 4) & 3, ip, size_t(iend - ip), of, 31, 8,
                    kOFDefault, 29, 5);
    ip += seq_table((modes >> 2) & 3, ip, size_t(iend - ip), ml, 52, 9,
                    kMLDefault, 53, 6);
    have_seq = true;
    if (ip > iend) fail("sequence tables past the block");
    BackBits bs(ip, size_t(iend - ip));
    uint32_t sll = uint32_t(bs.read(ll.log));
    uint32_t sof = uint32_t(bs.read(of.log));
    uint32_t sml = uint32_t(bs.read(ml.log));
    size_t litpos = 0;
    for (size_t k = 0; k < nbSeq; ++k) {
      const int ofc = of.table[sof].symbol;
      const int mlc = ml.table[sml].symbol;
      const int llc = ll.table[sll].symbol;
      uint64_t offset;
      const uint64_t ofv = (uint64_t(1) << ofc) + bs.read(ofc);
      const uint64_t mlen = kMLBase[mlc] + bs.read(kMLBits[mlc]);
      const uint64_t llen = kLLBase[llc] + bs.read(kLLBits[llc]);
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        const int idx = int(ofv - 1) + (llen == 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          uint64_t t = idx == 3 ? rep[0] - 1 : rep[idx];
          if (t == 0) t = ~uint64_t(0);   // libzstd: refused below
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset = t;
        }
      }
      if (k + 1 < nbSeq) {
        sll = ll.table[sll].newState + uint32_t(bs.read(ll.table[sll].nbBits));
        sml = ml.table[sml].newState + uint32_t(bs.read(ml.table[sml].nbBits));
        sof = of.table[sof].newState + uint32_t(bs.read(of.table[sof].nbBits));
      }
      if (llen > lit.size() - litpos) fail("a sequence past its literals");
      if (out.size() - base + llen + mlen > block_max)
        fail("a block above its maximum size");
      out.insert(out.end(), lit.begin() + int64_t(litpos),
                 lit.begin() + int64_t(litpos + llen));
      litpos += llen;
      if (offset > out.size()) fail("an offset before the frame's start");
      size_t from = out.size() - offset;
      for (uint64_t m = 0; m < mlen; ++m) out.push_back(out[from++]);
    }
    if (!bs.exact_end()) fail("a sequences bitstream not read to its end");
    if (out.size() - base + (lit.size() - litpos) > block_max)
      fail("a block above its maximum size");
    out.insert(out.end(), lit.begin() + int64_t(litpos), lit.end());
  }
};

struct Header {
  size_t size;   // bytes of the frame header
  uint64_t window, content;
  bool checksum;
};

// ZSTD_getFrameHeader and ZSTD_decodeFrameHeader's checks; size 0 where
// the data ends within the header
Header frame_header(const uint8_t* in, size_t n) {
  Header h{0, 0, kUnknown, false};
  if (n < 5) return h;
  const int fhd = in[4];
  const int fcs_flag = fhd >> 6;
  const bool single = (fhd >> 5) & 1;
  const int did_flag = fhd & 3;
  const size_t size = 5 + (single ? 0 : 1) + size_t(did_flag == 3 ? 4
                                                   : did_flag) +
                      size_t(fcs_flag == 0 ? (single ? 1 : 0)
                                           : 1 << fcs_flag);
  if (n < size) return h;
  if (fhd & 0x08) fail("reserved bit set in the frame header");
  size_t pos = 5;
  if (!single) {
    const int wd = in[pos++];
    const int wlog = 10 + (wd >> 3);
    if (wlog > 31) fail("a window above libzstd's maximum");
    const uint64_t base = uint64_t(1) << wlog;
    h.window = base + (base >> 3) * uint64_t(wd & 7);
  }
  uint32_t dict = 0;
  for (int k = 0; k < (did_flag == 3 ? 4 : did_flag); ++k)
    dict |= uint32_t(in[pos++]) << (8 * k);
  if (fcs_flag == 0 && single) {
    h.content = in[pos];
  } else if (fcs_flag == 1) {
    h.content = (in[pos] | uint64_t(in[pos + 1]) << 8) + 256;
  } else if (fcs_flag == 2) {
    h.content = le32(in + pos);
  } else if (fcs_flag == 3) {
    h.content = le64(in + pos);
  }
  if (single) h.window = h.content;
  h.checksum = (fhd >> 2) & 1;
  h.size = size;
  if (dict) fail("a frame that needs dictionary " + std::to_string(dict));
  return h;
}

// ZSTD_findFrameCompressedSize: 0 where the frame does not lie whole in
// the data or its block headers are bad
size_t whole_frame(const uint8_t* in, size_t n, const Header& h) {
  size_t pos = h.size;
  for (;;) {
    if (pos + 3 > n) return 0;
    const uint32_t bh = in[pos] | uint32_t(in[pos + 1]) << 8 |
                        uint32_t(in[pos + 2]) << 16;
    const int type = (bh >> 1) & 3;
    if (type == 3) return 0;
    const size_t csize = type == 1 ? 1 : bh >> 3;
    pos += 3;
    if (pos + csize > n) return 0;
    pos += csize;
    if (bh & 1) break;
  }
  if (h.checksum) pos += 4;
  return pos > n ? 0 : pos;
}

}  // namespace

void decode(const uint8_t* in, size_t n, uint8_t* out, size_t need) {
  if (n >= 4 && (le32(in) & 0xFFFFFFF0u) == 0x184D2A50u)
    fail("a skippable frame, and nothing decoded");
  if (n >= 4 && le32(in) != kMagic) fail("unknown frame descriptor");
  const Header h = frame_header(in, n);
  if (h.size == 0) fail("not enough data: the data ends in a frame header");
  std::vector<uint8_t> history;
  Frame f(history);
  f.block_max = size_t(std::min<uint64_t>(h.window, kBlockMax));
  Xxh64 xxh;
  size_t delivered = 0;   // bytes of out written
  const bool one_pass = h.content != kUnknown && need >= h.content &&
                        whole_frame(in, n, h) != 0;
  if (!one_pass) {
    const uint64_t window = std::max<uint64_t>(h.window, 1024);
    if (window > kWindowMax)
      fail("a window of " + std::to_string(window) +
           " bytes, above libzstd's limit of 2^27");
  }
  size_t pos = h.size;
  for (;;) {
    if (pos + 3 > n) break;   // the data ends: libzstd waits for more
    const uint32_t bh = in[pos] | uint32_t(in[pos + 1]) << 8 |
                        uint32_t(in[pos + 2]) << 16;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t csize = bh >> 3;
    if (type == 3) fail("a block of the reserved type");
    if ((type == 1 ? 1 : csize) > f.block_max)
      fail("a block above its maximum size");
    pos += 3;
    const size_t before = history.size();
    bool partial = false;
    if (type == 0) {   // a raw block's bytes are taken as they arrive
      const size_t avail = std::min(csize, n - pos);
      partial = avail < csize;
      history.insert(history.end(), in + pos, in + pos + avail);
      pos += avail;
    } else if (type == 1) {
      if (pos + 1 > n) break;
      if (csize > f.block_max) fail("a block above its maximum size");
      history.insert(history.end(), csize, in[pos]);
      pos += 1;
    } else {
      if (pos + csize > n) break;
      f.block(in + pos, csize);
      pos += csize;
    }
    const size_t got = history.size() - before;
    if (one_pass && history.size() > need)
      fail("the frame overflows the strip");
    if (h.content != kUnknown && history.size() > h.content)
      fail("more data than the frame's content size");
    if (last && !partial && h.content != kUnknown &&
        history.size() != h.content)
      fail("less data than the frame's content size");
    xxh.update(history.data() + before, got);
    const size_t take = std::min(got, need - delivered);
    std::memcpy(out + delivered, history.data() + before, take);
    delivered += take;
    if (partial || take < got) break;   // no more data, or no more room
    if (last) {
      if (h.checksum && pos + 4 <= n &&
          le32(in + pos) != uint32_t(xxh.digest()))
        fail("checksum mismatch");
      break;
    }
    if (delivered == need) {
      // the room is full: libzstd reads on to the next block header and
      // block only; their errors count, their bytes are not flushed
      if (pos + 3 > n) break;
      const uint32_t nh = in[pos] | uint32_t(in[pos + 1]) << 8 |
                          uint32_t(in[pos + 2]) << 16;
      const int ntype = (nh >> 1) & 3;
      const size_t nsize = nh >> 3;
      if (ntype == 3) fail("a block of the reserved type");
      if ((ntype == 1 ? 1 : nsize) > f.block_max || nsize > f.block_max)
        fail("a block above its maximum size");
      pos += 3;
      if (ntype == 2 && pos + nsize <= n) f.block(in + pos, nsize);
      break;
    }
  }
  if (delivered < need)
    fail("not enough data (short " + std::to_string(need - delivered) +
         " bytes)");
}

std::vector<uint8_t> decode_frame(const uint8_t* in, size_t n,
                                  size_t limit) {
  if (n < 4 || le32(in) != kMagic) fail("not a Zstandard frame");
  const Header h = frame_header(in, n);
  if (h.size == 0) fail("the data ends in the frame header");
  if (h.content != kUnknown && h.content > limit)
    fail("a content size of " + std::to_string(h.content) +
         " bytes, above the limit of " + std::to_string(limit));
  std::vector<uint8_t> out;
  if (h.content != kUnknown) out.reserve(size_t(h.content));
  Frame f(out);
  f.block_max = size_t(std::min<uint64_t>(h.window, kBlockMax));
  Xxh64 xxh;
  size_t pos = h.size;
  for (;;) {
    if (pos + 3 > n) fail("the data ends within the frame");
    const uint32_t bh = in[pos] | uint32_t(in[pos + 1]) << 8 |
                        uint32_t(in[pos + 2]) << 16;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t csize = bh >> 3;
    if (type == 3) fail("a block of the reserved type");
    if (csize > f.block_max) fail("a block above its maximum size");
    pos += 3;
    const size_t before = out.size();
    if (out.size() + (type == 2 ? 0 : csize) > limit)
      fail("more than the limit of " + std::to_string(limit) + " bytes");
    if (type == 0) {
      if (csize > n - pos) fail("the data ends within a block");
      out.insert(out.end(), in + pos, in + pos + csize);
      pos += csize;
    } else if (type == 1) {
      if (pos + 1 > n) fail("the data ends within a block");
      out.insert(out.end(), csize, in[pos]);
      pos += 1;
    } else {
      if (csize > n - pos) fail("the data ends within a block");
      f.block(in + pos, csize);
      pos += csize;
    }
    if (out.size() > limit)
      fail("more than the limit of " + std::to_string(limit) + " bytes");
    if (h.content != kUnknown && out.size() > h.content)
      fail("more data than the frame's content size");
    xxh.update(out.data() + before, out.size() - before);
    if (last) break;
  }
  if (h.content != kUnknown && out.size() != h.content)
    fail("less data than the frame's content size");
  if (h.checksum) {
    if (n - pos < 4) fail("the data ends in the checksum");
    if (le32(in + pos) != uint32_t(xxh.digest())) fail("checksum mismatch");
    pos += 4;
  }
  if (pos != n)
    fail(std::to_string(n - pos) + " bytes after the frame");
  return out;
}

}  // namespace mmst_zstd

// The whole-frame decoder for Python (data/native_loader.py): the output
// malloc'ed and handed to the caller, who frees it with mmst_zstd_free. An
// error's reason is copied into err (NUL-terminated) and 1 returned.
extern "C" {

int mmst_zstd_frame(const uint8_t* in, size_t n, size_t limit, uint8_t** out,
                    size_t* size, char* err, int errlen) {
  *out = nullptr;
  try {
    std::vector<uint8_t> bytes = mmst_zstd::decode_frame(in, n, limit);
    *out = static_cast<uint8_t*>(std::malloc(bytes.empty() ? 1
                                                           : bytes.size()));
    if (!*out) throw std::bad_alloc();
    std::memcpy(*out, bytes.data(), bytes.size());
    *size = bytes.size();
    return 0;
  } catch (const std::exception& e) {
    if (errlen > 0) {
      std::strncpy(err, e.what(), size_t(errlen) - 1);
      err[errlen - 1] = 0;
    }
    return 1;
  }
}

void mmst_zstd_free(void* p) { std::free(p); }

}  // extern "C"
