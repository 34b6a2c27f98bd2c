// Baseline JPEG decoder and encoder, with no library beyond libstdc++.
//
// The decoder reads what baseline writers give: SOF0 and SOF1 Huffman
// scans at 8 bits, grayscale or three components (YCbCr, or RGB where an
// Adobe marker or the component ids say so), any integer sampling (4:4:4,
// 4:2:2, 4:2:0, 4:4:0, ...), interleaved or one scan per component,
// DRI/RSTn restart intervals; the standard Huffman tables stand in for
// missing ones (Motion-JPEG frames), as libjpeg-turbo does. Its arithmetic
// is libjpeg's default decompression, so that the pixels are what PIL and
// libjpeg-turbo give:
//   * the integer "islow" inverse DCT (IJG jidctint.c, with the range
//     limit's wraparound table),
//   * fancy (triangular) chroma upsampling (jdsample.c: h2v1, h1v2, h2v2
//     with their bias terms; box replication where a chroma plane is at
//     most 2 samples wide, or for other ratios),
//   * the JFIF YCbCr -> RGB conversion with libjpeg's fixed-point tables
//     (jdcolor.c).
// A progressive (SOF2), lossless, arithmetic-coded or 12-bit file, a
// CMYK/YCCK one and a truncated or corrupt one throw std::runtime_error
// naming the reason (the SOF marker for the unsupported kinds). So does a
// frame above kMaxPixels, or one whose scans could not fit in the file's
// bytes, before anything of its size is allocated: the decoder reads
// untrusted request bodies. A DC table with a symbol above 15 is refused
// as libjpeg refuses it (jdhuff.c jpeg_make_d_derived_tbl), and a DC
// prediction that leaves int's range as libjpeg-turbo refuses it.
//
// The encoder writes a baseline 4:2:0 JFIF as libjpeg does at a quality
// setting with its defaults (PIL's Image.save(..., "JPEG", quality=q)):
// the IJG standard quantization tables scaled by jpeg_quality_scaling,
// the standard Huffman tables (no optimization), the integer forward DCT
// (jfdctint.c) and libjpeg's rounding division, RGB -> YCbCr and the 2x2
// chroma average with alternating bias as jccolor.c and jcsample.c, the
// edges padded and the dummy blocks past them as jcprepro.c and
// jccoefct.c make them: the bytes are libjpeg's.
//
// No function keeps state between calls: concurrent calls from many
// threads are safe.

#include "jpeg.h"

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace mmst_jpeg {
namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries: a corrupt run past the block's end lands here
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The IJG standard tables (ITU-T T.81 Annex K).
const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct StdHuff {
  uint8_t bits[17];  // bits[l]: codes of length l (bits[0] unused)
  const uint8_t* vals;
  int nvals;
};

const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// [class 0 = DC / 1 = AC][table 0 = luminance / 1 = chrominance]
const StdHuff kStdHuff[2][2] = {
    {{{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0}, kDcVals, 12},
     {{0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}, kDcVals, 12}},
    {{{0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
      kAcLumaVals, 162},
     {{0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77},
      kAcChromaVals, 162}}};

// PIL refuses an image above twice Image.MAX_IMAGE_PIXELS (89,478,485) as
// a decompression bomb; this decoder refuses it too.
constexpr int64_t kMaxPixels = 2 * int64_t(89478485);

[[noreturn]] void fail(const std::string& why) {
  throw std::runtime_error(why);
}

// Canonical Huffman code lengths and codes of a table (T.81 C.1, C.2).
void make_codes(const uint8_t* bits, int nvals, int* size, uint32_t* code) {
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) size[p++] = l;
  if (p != nvals) fail("bad Huffman table");
  uint32_t c = 0;
  int si = nvals ? size[0] : 0;
  for (int k = 0; k < nvals;) {
    while (k < nvals && size[k] == si) code[k++] = c++;
    if (c >= (1u << si)) fail("bad Huffman table");
    c <<= 1;
    ++si;
  }
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

constexpr int kLook = 9;

struct DecHuff {
  bool present = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[1 << kLook] = {};  // (length << 8) | symbol; 0: longer code

  void build(const uint8_t* bits, const uint8_t* v, int nvals) {
    int size[257];
    uint32_t code[257];
    make_codes(bits, nvals, size, code);
    std::memcpy(vals, v, nvals);
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - int32_t(code[p]);
        p += bits[l];
        maxcode[l] = int32_t(code[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    for (int k = 0; k < nvals; ++k) {
      if (size[k] > kLook) continue;
      int shift = kLook - size[k];
      for (int f = 0; f < (1 << shift); ++f)
        look[(code[k] << shift) | f] = uint16_t((size[k] << 8) | vals[k]);
    }
    present = true;
  }
};

// Entropy-coded bits, with 0xFF00 unstuffed; at a marker it feeds zeros.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= uint64_t(b) << (56 - n);
      n += 8;
    }
  }
  uint32_t peek(int k) {
    if (n < k) fill();
    return uint32_t(buf >> (64 - k));
  }
  void skip(int k) {
    buf <<= k;
    n -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return int(v);
  }
  int decode(const DecHuff& h) {
    uint32_t look = peek(kLook);
    uint16_t e = h.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int32_t code = int32_t(peek(16));
    for (int l = kLook + 1; l <= 16; ++l) {
      int32_t c = code >> (16 - l);
      if (c <= h.maxcode[l]) {
        skip(l);
        return h.vals[(c + h.valoffset[l]) & 0xFF];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }
  // After a restart interval: drop the padding bits and read RSTn.
  void restart() {
    buf = 0;
    n = 0;
    at_marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7))
      ++p;
    if (p + 1 >= end) fail("corrupt JPEG data: missing RST marker");
    p += 2;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// IJG jidctint.c ("islow"), the range limit of jdmaster.c included.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

inline uint8_t idct_limit(int64_t x) {
  int i = int(x & 1023);
  return uint8_t(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
}

void idct_islow(const int* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int* in = coef + c;
    const uint16_t* qp = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = int(int64_t(in[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qp[16], z3 = int64_t(in[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = int64_t(in[0]) * qp[0];
    z3 = int64_t(in[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qp[56];
    tmp1 = int64_t(in[40]) * qp[40];
    tmp2 = int64_t(in[24]) * qp[24];
    tmp3 = int64_t(in[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = kConstBits - kPass1Bits;
    w[0] = int(descale(tmp10 + tmp3, s));
    w[56] = int(descale(tmp10 - tmp3, s));
    w[8] = int(descale(tmp11 + tmp2, s));
    w[48] = int(descale(tmp11 - tmp2, s));
    w[16] = int(descale(tmp12 + tmp1, s));
    w[40] = int(descale(tmp12 - tmp1, s));
    w[24] = int(descale(tmp13 + tmp0, s));
    w[32] = int(descale(tmp13 - tmp0, s));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    const int s = kConstBits + kPass1Bits + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit(descale(tmp10 + tmp3, s));
    o[7] = idct_limit(descale(tmp10 - tmp3, s));
    o[1] = idct_limit(descale(tmp11 + tmp2, s));
    o[6] = idct_limit(descale(tmp11 - tmp2, s));
    o[2] = idct_limit(descale(tmp12 + tmp1, s));
    o[5] = idct_limit(descale(tmp12 - tmp1, s));
    o[3] = idct_limit(descale(tmp13 + tmp0, s));
    o[4] = idct_limit(descale(tmp13 - tmp0, s));
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;   // the current scan's table selectors
  int dc_pred = 0;
  int width = 0, height = 0;   // downsampled size (jdiv_round_up)
  int stride = 0, rows = 0;    // the plane, padded to whole MCUs
  std::vector<uint8_t> plane;
  bool decoded = false;
};

struct Decoder {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;
  uint16_t qt[4][64] = {};  // natural order
  bool qt_present[4] = {};
  DecHuff dc[4], ac[4];
  std::vector<Component> comps;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;

  uint8_t byte() {
    if (pos >= size) fail("truncated JPEG");
    return data[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  // A marker segment's payload [pos, seg_end); pos moves past it after.
  size_t segment() {
    int len = u16();
    if (len < 2 || pos + len - 2 > size) fail("truncated JPEG segment");
    return pos + len - 2;
  }

  void read_dqt() {
    size_t end = segment();
    while (pos < end) {
      int pq = byte(), t = pq & 15;
      pq >>= 4;
      if (t > 3 || pq > 1) fail("bad DQT segment");
      for (int i = 0; i < 64; ++i)
        qt[t][kNatural[i]] = uint16_t(pq ? u16() : byte());
      qt_present[t] = true;
    }
    pos = end;
  }

  void read_dht() {
    size_t end = segment();
    while (pos < end) {
      int tc = byte(), th = tc & 15;
      tc >>= 4;
      if (tc > 1 || th > 3) fail("bad DHT segment");
      uint8_t bits[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += bits[l] = byte();
      if (total > 256 || pos + total > end) fail("bad DHT segment");
      for (int i = 0; i < total && !tc; ++i)
        if (data[pos + i] > 15) fail("bad DHT segment: a DC symbol above 15");
      (tc ? ac : dc)[th].build(bits, data + pos, total);
      pos += total;
    }
    pos = end;
  }

  void read_sof(int marker) {
    if (frame) fail("more than one frame");
    size_t end = segment();
    int precision = byte();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG (SOF" +
           std::to_string(marker - 0xC0) + ") is not supported");
    height = u16();
    width = u16();
    int n = byte();
    if (width <= 0 || height <= 0)
      fail("JPEG without its size in the frame header (DNL) is not "
           "supported");
    if (n != 1 && n != 3)
      fail(std::to_string(n) + "-component JPEG (CMYK/YCCK) is not "
           "supported");
    comps.resize(n);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad SOF segment");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    pos = end;
    if (int64_t(width) * height > kMaxPixels)
      fail("JPEG of " + std::to_string(width) + "x" + std::to_string(height) +
           " pixels is above the limit of " + std::to_string(kMaxPixels) +
           " (a decompression bomb)");
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    // Every block of every component is coded, in 2 bits at the least (a
    // 1-bit DC code and a 1-bit EOB): a file of `size` bytes holds at most
    // 4 * size of them.
    int64_t blocks = 0;
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        fail("unsupported chroma sampling");
      c.width = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.height = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.stride = mcus_x * c.h * 8;
      c.rows = mcus_y * c.v * 8;
      blocks += int64_t(c.width + 7) / 8 * ((c.height + 7) / 8);
    }
    if (blocks > 4 * int64_t(size))
      fail("corrupt JPEG data: " + std::to_string(size) + " bytes cannot "
           "hold a " + std::to_string(width) + "x" + std::to_string(height) +
           " frame");
    frame = true;
  }

  void decode_block(Bits& bits, Component& c, uint8_t* out) {
    int coef[64] = {0};
    const DecHuff& hd = dc[c.td];
    const DecHuff& ha = ac[c.ta];
    int s = bits.decode(hd);
    const int64_t pred = int64_t(c.dc_pred) + (s ? extend(bits.get(s), s) : 0);
    if (pred > INT32_MAX || pred < INT32_MIN)
      fail("corrupt JPEG data: DC coefficient out of range");
    c.dc_pred = int(pred);
    coef[0] = int16_t(c.dc_pred);  // libjpeg's JCOEF is 16 bits
    for (int k = 1; k < 64;) {
      int rs = bits.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = extend(bits.get(s), s);
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    idct_islow(coef, qt[c.tq], out, c.stride);
  }

  void read_sos() {
    if (!frame) fail("scan before the frame header");
    size_t end = segment();
    int ns = byte();
    if (ns < 1 || ns > int(comps.size())) fail("bad SOS segment");
    std::vector<Component*> scan;
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found || found->decoded) fail("bad SOS segment");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3) fail("bad SOS segment");
      if (!qt_present[found->tq]) fail("missing quantization table");
      scan.push_back(found);
    }
    pos = end;  // Ss, Se, Ah/Al are 0, 63, 0 in a sequential scan
    for (Component* c : scan) {
      // libjpeg-turbo's default tables where a stream has none (MJPEG)
      for (int cls = 0; cls < 2; ++cls) {
        int t = cls ? c->ta : c->td;
        DecHuff& h = (cls ? ac : dc)[t];
        if (!h.present) {
          const StdHuff& sh = kStdHuff[cls][t ? 1 : 0];
          h.build(sh.bits, sh.vals, sh.nvals);
        }
      }
      c->dc_pred = 0;
    }
    Bits bits{data + pos, data + size};
    int units_x, units_y;  // MCUs (interleaved) or blocks (one component)
    if (ns == 1) {
      units_x = (scan[0]->width + 7) / 8;
      units_y = (scan[0]->height + 7) / 8;
    } else {
      units_x = mcus_x;
      units_y = mcus_y;
    }
    int todo = restart_interval;
    for (int my = 0; my < units_y; ++my) {
      for (int mx = 0; mx < units_x; ++mx) {
        if (restart_interval) {
          if (todo == 0) {
            bits.restart();
            for (Component* c : scan) c->dc_pred = 0;
            todo = restart_interval;
          }
          --todo;
        }
        if (ns == 1) {
          Component& c = *scan[0];
          decode_block(bits, c,
                       c.plane.data() + size_t(my) * 8 * c.stride + mx * 8);
          continue;
        }
        for (Component* c : scan)
          for (int by = 0; by < c->v; ++by)
            for (int bx = 0; bx < c->h; ++bx)
              decode_block(bits, *c,
                           c->plane.data() +
                               size_t(my * c->v + by) * 8 * c->stride +
                               (mx * c->h + bx) * 8);
      }
    }
    for (Component* c : scan) c->decoded = true;
    // Past the scan: to the first marker that is not a restart marker.
    const uint8_t* p = bits.p;
    while (p + 1 < data + size &&
           !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF &&
             !(p[1] >= 0xD0 && p[1] <= 0xD7)))
      ++p;
    pos = size_t(p - data);
  }

  // A component's plane upsampled to the image's size (jdsample.c): rows
  // and columns past the plane's own size are its last ones repeated.
  std::vector<uint8_t> upsample(const Component& c) const {
    const int hf = hmax / c.h, vf = vmax / c.v;
    const int cw = c.width, ch = c.height;
    std::vector<uint8_t> out(size_t(width) * height);
    std::vector<int> sum(size_t(cw) + 2);  // with a repeated edge each side
    auto row = [&](int r) {
      return c.plane.data() + size_t(std::min(std::max(r, 0), ch - 1)) *
                                  c.stride;
    };
    const bool fancy_h = hf == 2 && cw > 2;
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out.data() + size_t(y) * width;
      const int sy = y / vf, dy = y % vf;
      const uint8_t* here = row(sy);
      if (hf == 1 && vf == 1) {
        std::memcpy(o, here, width);
        continue;
      }
      if (vf == 2 && (fancy_h || hf == 1)) {
        // triangular in y: 3/4 this row, 1/4 the nearer neighbour
        const uint8_t* near = row(dy ? sy + 1 : sy - 1);
        for (int i = 0; i < cw; ++i) sum[i + 1] = 3 * here[i] + near[i];
        if (hf == 1) {  // h1v2
          const int bias = dy ? 2 : 1;
          for (int x = 0; x < width; ++x)
            o[x] = uint8_t((sum[x + 1] + bias) >> 2);
          continue;
        }
      } else if (fancy_h && vf == 1) {
        for (int i = 0; i < cw; ++i) sum[i + 1] = here[i];
      } else {  // box replication
        for (int x = 0; x < width; ++x) o[x] = here[x / hf];
        continue;
      }
      sum[0] = sum[1];
      sum[cw + 1] = sum[cw];
      // triangular in x: h2v2 in 4 x 16ths (+8, +7), h2v1 in 4ths (+1, +2)
      const int shift = vf == 2 ? 4 : 2;
      const int b0 = vf == 2 ? 8 : 1, b1 = vf == 2 ? 7 : 2;
      for (int x = 0; x < width; ++x) {
        const int i = (x >> 1) + 1;
        o[x] = uint8_t(x & 1 ? (3 * sum[i] + sum[i + 1] + b1) >> shift
                             : (3 * sum[i] + sum[i - 1] + b0) >> shift);
      }
    }
    return out;
  }

  // With out == nullptr: read up to the frame header and stop (width and
  // height are then known). Otherwise decode the whole file into out, which
  // holds width x height x 3 bytes of a frame of that size.
  void run(uint8_t* out, int want_w, int want_h) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG (no SOI marker)");
    pos = 2;
    for (;;) {
      // markers may be preceded by fill bytes 0xFF
      if (byte() != 0xFF) fail("corrupt JPEG data: expected a marker");
      int m = byte();
      while (m == 0xFF) m = byte();
      if (m == 0xD9) break;  // EOI
      if (m == 0xC0 || m == 0xC1) {
        read_sof(m);
        if (!out) return;
        for (auto& c : comps) c.plane.assign(size_t(c.stride) * c.rows, 0);
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        fail("progressive JPEG (SOF" + std::to_string(m - 0xC0) +
             ") is not supported");
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        fail("lossless JPEG (SOF" + std::to_string(m - 0xC0) +
             ") is not supported");
      } else if (m == 0xC5 || m == 0xC9 || m == 0xCD) {
        fail((m == 0xC5 ? "hierarchical JPEG (SOF" : "arithmetic-coded "
              "JPEG (SOF") + std::to_string(m - 0xC0) +
             ") is not supported");
      } else if (m == 0xCC) {
        fail("arithmetic-coded JPEG (DAC) is not supported");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        size_t end = segment();
        restart_interval = u16();
        pos = end;
      } else if (m == 0xDA) {
        read_sos();
      } else if (m >= 0xD0 && m <= 0xD7) {
        continue;  // a stray restart marker between segments
      } else {
        size_t end = segment();  // APPn, COM and the rest
        if (m == 0xE0 && end - pos >= 5 &&
            std::memcmp(data + pos, "JFIF\0", 5) == 0)
          jfif = true;
        if (m == 0xEE && end - pos >= 12 &&
            std::memcmp(data + pos, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[pos + 11];
        }
        pos = end;
      }
    }
    if (!frame) fail("JPEG without a frame header");
    for (auto& c : comps)
      if (!c.decoded) fail("truncated JPEG: a component has no scan");
    if (width != want_w || height != want_h)
      fail("JPEG frame of another size than its header gave");
    uint8_t* o = out;
    if (comps.size() == 1) {
      std::vector<uint8_t> g = upsample(comps[0]);
      for (size_t i = 0; i < g.size(); ++i)
        o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = g[i];
      return;
    }
    // jdapimin.c default_decompress_parms: JFIF implies YCbCr; else the
    // Adobe transform; else component ids 'R', 'G', 'B' mean RGB.
    bool is_rgb = !jfif && (adobe ? adobe_transform == 0
                                  : comps[0].id == 'R' && comps[1].id == 'G'
                                        && comps[2].id == 'B');
    std::vector<uint8_t> p0 = upsample(comps[0]), p1 = upsample(comps[1]),
                         p2 = upsample(comps[2]);
    const size_t n = p0.size();
    if (is_rgb) {
      for (size_t i = 0; i < n; ++i) {
        o[3 * i] = p0[i];
        o[3 * i + 1] = p1[i];
        o[3 * i + 2] = p2[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((91881 * x + half) >> 16);
      cb_b[i] = int((116130 * x + half) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + half;
    }
    auto limit = [](int v) {
      return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    for (size_t i = 0; i < n; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      o[3 * i] = limit(y + cr_r[cr]);
      o[3 * i + 1] = limit(y + int((cb_g[cb] + cr_g[cr]) >> 16));
      o[3 * i + 2] = limit(y + cb_b[cb]);
    }
  }
};

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

// IJG jfdctint.c ("islow"), results scaled up by 8.
void fdct_islow(int* d) {
  for (int r = 0; r < 8; ++r) {
    int* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0541;
    const int s = kConstBits - kPass1Bits;
    p[2] = int(descale(z1 + tmp13 * F0765, s));
    p[6] = int(descale(z1 + tmp12 * -F1847, s));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1175;
    tmp4 *= F0298;
    tmp5 *= F2053;
    tmp6 *= F3072;
    tmp7 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    p[7] = int(descale(tmp4 + z1 + z3, s));
    p[5] = int(descale(tmp5 + z2 + z4, s));
    p[3] = int(descale(tmp6 + z2 + z3, s));
    p[1] = int(descale(tmp7 + z1 + z4, s));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0541;
    const int s = kConstBits + kPass1Bits;
    p[16] = int(descale(z1 + tmp13 * F0765, s));
    p[48] = int(descale(z1 + tmp12 * -F1847, s));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1175;
    tmp4 *= F0298;
    tmp5 *= F2053;
    tmp6 *= F3072;
    tmp7 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    p[56] = int(descale(tmp4 + z1 + z3, s));
    p[40] = int(descale(tmp5 + z2 + z4, s));
    p[24] = int(descale(tmp6 + z2 + z3, s));
    p[8] = int(descale(tmp7 + z1 + z4, s));
  }
}

struct EncHuff {
  uint32_t code[256] = {};
  uint8_t size[256] = {};
  explicit EncHuff(const StdHuff& t) {
    int sizes[257];
    uint32_t codes[257];
    make_codes(t.bits, t.nvals, sizes, codes);
    for (int k = 0; k < t.nvals; ++k) {
      code[t.vals[k]] = codes[k];
      size[t.vals[k]] = uint8_t(sizes[k]);
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t bits, int k) {
    acc = (acc << k) | (bits & ((1u << k) - 1));
    n += k;
    while (n >= 8) {
      uint8_t b = uint8_t(acc >> (n - 8));
      out->push_back(b);
      if (b == 0xFF) out->push_back(0);
      n -= 8;
    }
  }
  void flush() {
    if (n) put(0x7F, 8 - n);
  }
};

// The forward DCT of one 8 x 8 block of samples and libjpeg's rounding
// division by 8 q (jcdctmgr.c), in natural order.
void quantize_block(const uint8_t* src, int stride, const uint16_t* q,
                    int* coef) {
  int d[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) d[8 * r + c] = int(src[r * stride + c]) - 128;
  fdct_islow(d);
  for (int i = 0; i < 64; ++i) {
    int qv = q[i] << 3, t = d[i];
    coef[i] = t < 0 ? -((-t + (qv >> 1)) / qv) : (t + (qv >> 1)) / qv;
  }
}

// One block's Huffman codes (jchuff.c encode_one_block).
void encode_block(const int* coef, const EncHuff& dc, const EncHuff& ac,
                  int* last_dc, BitWriter& bw) {
  auto magnitude = [](int v, int* bits) {
    int a = v < 0 ? -v : v, nb = 0;
    *bits = v < 0 ? v - 1 : v;
    while (a) {
      ++nb;
      a >>= 1;
    }
    return nb;
  };
  int bits, nb = magnitude(coef[0] - *last_dc, &bits);
  *last_dc = coef[0];
  bw.put(dc.code[nb], dc.size[nb]);
  if (nb) bw.put(uint32_t(bits), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kNatural[k]];
    if (!v) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    nb = magnitude(v, &bits);
    int sym = (run << 4) | nb;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(uint32_t(bits), nb);
    run = 0;
  }
  if (run) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 0xFF));
}

void put_dht(std::vector<uint8_t>& o, int cls, int id, const StdHuff& t) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + t.nvals);
  o.push_back(uint8_t(cls << 4 | id));
  for (int l = 1; l <= 16; ++l) o.push_back(t.bits[l]);
  o.insert(o.end(), t.vals, t.vals + t.nvals);
}

}  // namespace

void info(const uint8_t* data, size_t size, int* width, int* height) {
  Decoder d;
  d.data = data;
  d.size = size;
  d.run(nullptr, 0, 0);
  *width = d.width;
  *height = d.height;
}

void decode(const uint8_t* data, size_t size, uint8_t* rgb, int width,
            int height) {
  Decoder d;
  d.data = data;
  d.size = size;
  d.run(rgb, width, height);
}

std::vector<uint8_t> encode(const uint8_t* rgb, int width, int height,
                            int quality) {
  if (width <= 0 || height <= 0 || width > 65535 || height > 65535)
    fail("image size out of JPEG's range");
  quality = std::min(std::max(quality, 1), 100);
  // jcparam.c jpeg_quality_scaling, jpeg_add_quant_table (baseline)
  const int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  uint16_t q[2][64];
  for (int i = 0; i < 64; ++i) {
    for (int t = 0; t < 2; ++t) {
      long v = ((t ? kStdChromaQ : kStdLumaQ)[i] * long(scale) + 50) / 100;
      q[t][i] = uint16_t(std::min(std::max(v, 1L), 255L));
    }
  }
  // RGB -> YCbCr (jccolor.c), the image's last row and column replicated
  // out to whole 16 x 16 MCUs (jcprepro.c, jcsample.c expand_*_edge).
  const int pw = (width + 15) & ~15, ph = (height + 15) & ~15;
  std::vector<uint8_t> y(size_t(pw) * ph), cb(y.size()), cr(y.size());
  const int64_t half = int64_t(1) << 15, off = int64_t(128) << 16;
  for (int r = 0; r < ph; ++r) {
    const uint8_t* row = rgb + size_t(std::min(r, height - 1)) * width * 3;
    for (int c = 0; c < pw; ++c) {
      const uint8_t* px = row + std::min(c, width - 1) * 3;
      int64_t R = px[0], G = px[1], B = px[2];
      size_t i = size_t(r) * pw + c;
      y[i] = uint8_t((19595 * R + 38470 * G + 7471 * B + half) >> 16);
      cb[i] = uint8_t((-11059 * R - 21709 * G + 32768 * B + off + half - 1)
                      >> 16);
      cr[i] = uint8_t((32768 * R - 27439 * G - 5329 * B + off + half - 1)
                      >> 16);
    }
  }
  // 2 x 2 averages with the alternating bias 1, 2 (jcsample.c) over the
  // image's ceil(H / 2) chroma rows; below them the last one is repeated
  // to the MCU's height (jcprepro.c pads the downsampled rows).
  const int cw = pw / 2, chh = ph / 2, crows = (height + 1) / 2;
  std::vector<uint8_t> cbs(size_t(cw) * chh), crs(cbs.size());
  for (int r = 0; r < chh; ++r) {
    const int sr = std::min(r, crows - 1);
    for (int c = 0, bias = 1; c < cw; ++c, bias ^= 3) {
      size_t a = size_t(2 * sr) * pw + 2 * c, b = a + pw;
      cbs[size_t(r) * cw + c] =
          uint8_t((cb[a] + cb[a + 1] + cb[b] + cb[b + 1] + bias) >> 2);
      crs[size_t(r) * cw + c] =
          uint8_t((cr[a] + cr[a + 1] + cr[b] + cr[b + 1] + bias) >> 2);
    }
  }
  std::vector<uint8_t> o;
  o.reserve(size_t(width) * height / 2 + 1024);
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F',
                          0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), head, head + sizeof(head));
  for (int t = 0; t < 2; ++t) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(uint8_t(t));
    for (int i = 0; i < 64; ++i) o.push_back(uint8_t(q[t][kNatural[i]]));
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 17);
  o.push_back(8);
  put16(o, height);
  put16(o, width);
  o.push_back(3);
  const uint8_t comps[3][3] = {{1, 0x22, 0}, {2, 0x11, 1}, {3, 0x11, 1}};
  for (auto& c : comps) o.insert(o.end(), c, c + 3);
  put_dht(o, 0, 0, kStdHuff[0][0]);
  put_dht(o, 1, 0, kStdHuff[1][0]);
  put_dht(o, 0, 1, kStdHuff[0][1]);
  put_dht(o, 1, 1, kStdHuff[1][1]);
  const uint8_t sos[] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11,
                         0, 63, 0};
  o.insert(o.end(), sos, sos + sizeof(sos));
  const EncHuff dc0(kStdHuff[0][0]), ac0(kStdHuff[1][0]),
      dc1(kStdHuff[0][1]), ac1(kStdHuff[1][1]);
  BitWriter bw{&o};
  int last[3] = {0, 0, 0};
  // Luminance blocks past the image's last block row or column are
  // jccoefct.c's dummy blocks: no AC, the DC of the block before them in
  // the MCU (to the left; for a dummy row, the row above's last).
  const int wb = (width + 7) / 8, hb = (height + 7) / 8;
  int coef[64];
  for (int my = 0; my < ph / 16; ++my) {
    for (int mx = 0; mx < pw / 16; ++mx) {
      int prev_dc = 0;
      for (int b = 0; b < 4; ++b) {
        const int bx = mx * 2 + (b & 1), by = my * 2 + (b >> 1);
        if (bx < wb && by < hb) {
          quantize_block(y.data() + size_t(by) * 8 * pw + bx * 8, pw, q[0],
                         coef);
        } else {
          std::memset(coef, 0, sizeof(coef));
          coef[0] = prev_dc;
        }
        prev_dc = coef[0];
        encode_block(coef, dc0, ac0, &last[0], bw);
      }
      size_t ci = size_t(my * 8) * cw + mx * 8;
      quantize_block(cbs.data() + ci, cw, q[1], coef);
      encode_block(coef, dc1, ac1, &last[1], bw);
      quantize_block(crs.data() + ci, cw, q[1], coef);
      encode_block(coef, dc1, ac1, &last[2], bw);
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

}  // namespace mmst_jpeg

// The C ABI (data/native_loader.py). A decode is two calls: mmst_jpeg_info
// gives the size, mmst_jpeg_decode writes the pixels into the caller's
// width x height x 3 buffer. An encoded JPEG is malloc'ed and handed to the
// caller, who frees it with mmst_jpeg_free. An error's reason is copied
// into err (NUL-terminated) and 1 returned.
extern "C" {

static int mmst_jpeg_error(const std::exception& e, char* err, int errlen) {
  if (errlen > 0) {
    std::strncpy(err, e.what(), size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
  return 1;
}

int mmst_jpeg_info(const uint8_t* data, size_t size, int* width,
                   int* height, char* err, int errlen) {
  try {
    mmst_jpeg::info(data, size, width, height);
    return 0;
  } catch (const std::exception& e) {
    return mmst_jpeg_error(e, err, errlen);
  }
}

int mmst_jpeg_decode(const uint8_t* data, size_t size, uint8_t* rgb,
                     int width, int height, char* err, int errlen) {
  try {
    mmst_jpeg::decode(data, size, rgb, width, height);
    return 0;
  } catch (const std::exception& e) {
    return mmst_jpeg_error(e, err, errlen);
  }
}

int mmst_jpeg_encode(const uint8_t* rgb, int width, int height, int quality,
                     uint8_t** out, size_t* size, char* err, int errlen) {
  *out = nullptr;
  try {
    std::vector<uint8_t> bytes = mmst_jpeg::encode(rgb, width, height,
                                                   quality);
    *out = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!*out) throw std::bad_alloc();
    std::memcpy(*out, bytes.data(), bytes.size());
    *size = bytes.size();
    return 0;
  } catch (const std::exception& e) {
    return mmst_jpeg_error(e, err, errlen);
  }
}

void mmst_jpeg_free(void* p) { std::free(p); }

}  // extern "C"
