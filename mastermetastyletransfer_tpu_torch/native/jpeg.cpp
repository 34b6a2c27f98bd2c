// JPEG decoder and baseline encoder, with no library beyond libstdc++.
//
// The decoder reads what libjpeg-turbo reads in 8-bit JPEG: SOF0 and SOF1
// (sequential) and SOF2 (progressive) frames with Huffman coding, SOF9 and
// SOF10 (sequential and progressive) with arithmetic coding (jdarith.c,
// its DAC conditioning tables included) and SOF3 lossless frames
// (jdlhuff.c, jdpred.c: predictors 1-7, the point transform, restarts at
// whole MCU rows); grayscale, three components (YCbCr, or RGB where an
// Adobe marker or the component ids say so) or four (CMYK, or YCCK under
// an Adobe marker of transform 2, jdcolor.c ycck_cmyk_convert); any
// integer sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...), interleaved or one
// scan per component, DRI/RSTn restart intervals, DHT, DAC and DRI segments
// between scans; the standard Huffman tables stand in for missing ones
// (Motion-JPEG frames), as libjpeg-turbo does. A progressive frame's scans
// (spectral selection and successive approximation, jdphuff.c, jdarith.c)
// fill a buffer of every block's coefficients, dequantized at the end with
// the table latched at each component's first scan; where the scans leave
// coefficients 1-9 short of their last bit, libjpeg-turbo's block smoothing
// (jdcoefct.c decompress_smooth_data, 2.1 and later: coefficients 0-9 from
// the DC values of the 5 x 5 blocks around each) estimates them before the
// inverse DCT. Its arithmetic is libjpeg-turbo's default decompression
// with JCS_RGB (JCS_CMYK for four components), so that the pixels are what
// PIL and libjpeg-turbo give, at full size or at n/8 of it (n in 1..8,
// libjpeg's scale_num / scale_denom, jdmaster.c; a lossless frame at full
// size only):
//   * the inverse DCT of each output block size (jddctmgr.c): "islow" at
//     8 x 8, and jidctred.c's reduced ones at 4 and 2, as libjpeg-turbo's
//     SIMD code computes them (jidctint-avx2.asm, jidctred-sse2.asm: 16-
//     and 32-bit lanes, which tell only on a damaged stream), jidctint.c's
//     scaled routines at 3, 5, 6, 7, 10, 12 and 14 and jidctred.c's 1 x 1,
//     these with the range limit's wraparound table; a chroma component's
//     size doubles while its sampling allows (4:2:0 chroma decodes at 2n,
//     unupsampled);
//   * fancy (triangular) chroma upsampling (jdsample.c: h2v1, h1v2, h2v2
//     with their bias terms; box replication where a chroma plane is at
//     most 2 samples wide, at 1/8 scale, in a lossless frame, or for other
//     ratios),
//   * the JFIF YCbCr -> RGB conversion with libjpeg's fixed-point tables
//     (jdcolor.c).
// A CMYK or YCCK frame's pixels are what PIL's convert("RGB") makes of
// libjpeg's CMYK: the samples inverted (PIL reads every 4-component JPEG
// as "CMYK;I") and Pillow's cmyk2rgb (libImaging/Convert.c).
// Damaged and cut data are read as libjpeg recovers from them
// (jdmarker.c, jdhuff.c, jdphuff.c, jdarith.c, jdlhuff.c, jdcoefct.c): its
// markers read through its data source, whose end is where the callers
// differ (End): PIL's source suspends, and PIL keeps a file only where
// every row was out before the data ran out; jpeg_stdio_src (the JAX
// loader's) and libtiff's read a fake EOI past the end. A scan that meets
// a marker runs out of data: its MCUs to the next restart get no
// coefficients (a sequential block is then 0, mid grey; a progressive one
// keeps what the earlier scans gave it; block smoothing takes the
// coefficient bits before the scan for the rows it did not reach); a
// missing or misnumbered RSTn is resynced as jpeg_resync_to_restart does;
// a bogus progression (a band or bit coded again) is decoded as libjpeg
// decodes it; an arithmetic coding error ends its interval's data.
// A hierarchical, lossless arithmetic-coded or 12-bit file, one of 2
// components, and one libjpeg refuses throw std::runtime_error naming the
// reason (the SOF marker for the unsupported kinds). So does a frame above
// kMaxPixels, one whose scans could not fit in a request body's bytes
// (Huffman and lossless frames, PIL's source), and one whose coefficient
// buffer (progressive, or sequential in several scans) would be above the
// limit, before anything of its size is allocated: the decoder reads
// untrusted request bodies. A DC table with a symbol above 15 (16 in a
// lossless frame) is refused as libjpeg refuses it (jdhuff.c
// jpeg_make_d_derived_tbl), and a DC prediction that leaves int's range
// as libjpeg-turbo refuses it.
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
#include <cstdio>
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

// libjpeg-turbo converts no colour space of a lossless frame (jdcolor.c):
// YCbCr and YCCK ones are refused, RGB, CMYK and grey ones read as stored.
const char* const kLosslessColour =
    "lossless JPEG in YCbCr or YCCK is not supported (libjpeg converts no "
    "colour space of a lossless frame)";

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

constexpr int kLookahead = 8;     // jdhuff.h HUFF_LOOKAHEAD
constexpr int kMinGetBits = 57;   // jdhuff.h MIN_GET_BITS, 64-bit buffer
constexpr int kMaxBlocksInMcu = 10;   // jpeglib.h D_MAX_BLOCKS_IN_MCU

// A Huffman table as its DHT segment gives it, and libjpeg's decoding
// tables of it (jdhuff.c jpeg_make_d_derived_tbl), derived at each scan
// that reads it, where libjpeg checks it.
struct DecHuff {
  bool present = false;
  uint8_t bits[17] = {};   // bits[l]: codes of length l (bits[0] unused)
  uint8_t vals[256] = {};
  int nvals = 0;
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  // (length << 8) | symbol of each 8-bit lookahead; length 9: a longer code
  uint16_t lookup[1 << kLookahead] = {};

  void define(const uint8_t* b, const uint8_t* v, int n) {
    std::memcpy(bits, b, sizeof(bits));
    std::memset(vals, 0, sizeof(vals));
    std::memcpy(vals, v, size_t(n));
    nvals = n;
    present = true;
  }

  // max_dc: the largest symbol a DC table may hold (15; 16 lossless), or
  // -1 for an AC table, which may hold any.
  void derive(int max_dc) {
    int size[257];
    uint32_t code[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (p + bits[l] > 256) fail("bad Huffman table");
      for (int i = 0; i < bits[l]; ++i) size[p++] = l;
    }
    size[p] = 0;
    const int nsym = p;
    // canonical codes; a code of all ones does not fit its length
    uint32_t c = 0;
    int si = size[0];
    for (p = 0; size[p];) {
      while (size[p] == si) code[p++] = c++;
      if (c >= (1u << si)) fail("bad Huffman table");
      c <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - int32_t(code[p]);
        p += bits[l];
        maxcode[l] = int32_t(code[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;   // ends a garbage code at 17 bits
    for (auto& e : lookup) e = (kLookahead + 1) << kLookahead;
    p = 0;
    for (int l = 1; l <= kLookahead; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        int look = int(code[p]) << (kLookahead - l);
        for (int n = 1 << (kLookahead - l); n > 0; --n)
          lookup[look++] = uint16_t(l << kLookahead | vals[p]);
      }
    }
    if (max_dc >= 0)
      for (int i = 0; i < nsym; ++i)
        if (vals[i] > max_dc)
          fail("bad DHT segment: a DC symbol above " +
               std::to_string(max_dc));
  }
};

// How the data ends, as each caller's libjpeg data source meets it.
enum class End {
  // PIL's (Pillow's JpegDecode.c, whose fill_input_buffer suspends):
  // ImageFile.load hands the file over in reads of kPilBlock bytes and
  // raises "image file is truncated" where it has none left and libjpeg
  // has not output every row.
  kSuspend,
  // jpeg_stdio_src's (the JAX loader's) and libtiff's: past the end,
  // libjpeg warns and reads a fake EOI marker, FF D9, again and again.
  kFakeEoi,
};
constexpr size_t kPilBlock = 65536;   // ImageFile's MAXBLOCK

// PIL's data source ran dry.
struct Suspended {};

// The arithmetic decoder's probability estimation (T.81 Table D.2, as
// libjpeg's jaricom.c packs it): Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed estimate of
// 0.5 that signs and refinement bits use.
constexpr int32_t ari(int qe, int nl, int nm, int sw) {
  return int32_t(qe) << 16 | nm << 8 | sw << 7 | nl;
}
const int32_t kAriTab[114] = {
    ari(0x5a1d, 1, 1, 1),     ari(0x2586, 14, 2, 0),
    ari(0x1114, 16, 3, 0),    ari(0x080b, 18, 4, 0),
    ari(0x03d8, 20, 5, 0),    ari(0x01da, 23, 6, 0),
    ari(0x00e5, 25, 7, 0),    ari(0x006f, 28, 8, 0),
    ari(0x0036, 30, 9, 0),    ari(0x001a, 33, 10, 0),
    ari(0x000d, 35, 11, 0),   ari(0x0006, 9, 12, 0),
    ari(0x0003, 10, 13, 0),   ari(0x0001, 12, 13, 0),
    ari(0x5a7f, 15, 15, 1),   ari(0x3f25, 36, 16, 0),
    ari(0x2cf2, 38, 17, 0),   ari(0x207c, 39, 18, 0),
    ari(0x17b9, 40, 19, 0),   ari(0x1182, 42, 20, 0),
    ari(0x0cef, 43, 21, 0),   ari(0x09a1, 45, 22, 0),
    ari(0x072f, 46, 23, 0),   ari(0x055c, 48, 24, 0),
    ari(0x0406, 49, 25, 0),   ari(0x0303, 51, 26, 0),
    ari(0x0240, 52, 27, 0),   ari(0x01b1, 54, 28, 0),
    ari(0x0144, 56, 29, 0),   ari(0x00f5, 57, 30, 0),
    ari(0x00b7, 59, 31, 0),   ari(0x008a, 60, 32, 0),
    ari(0x0068, 62, 33, 0),   ari(0x004e, 63, 34, 0),
    ari(0x003b, 32, 35, 0),   ari(0x002c, 33, 9, 0),
    ari(0x5ae1, 37, 37, 1),   ari(0x484c, 64, 38, 0),
    ari(0x3a0d, 65, 39, 0),   ari(0x2ef1, 67, 40, 0),
    ari(0x261f, 68, 41, 0),   ari(0x1f33, 69, 42, 0),
    ari(0x19a8, 70, 43, 0),   ari(0x1518, 72, 44, 0),
    ari(0x1177, 73, 45, 0),   ari(0x0e74, 74, 46, 0),
    ari(0x0bfb, 75, 47, 0),   ari(0x09f8, 77, 48, 0),
    ari(0x0861, 78, 49, 0),   ari(0x0706, 79, 50, 0),
    ari(0x05cd, 48, 51, 0),   ari(0x04de, 50, 52, 0),
    ari(0x040f, 50, 53, 0),   ari(0x0363, 51, 54, 0),
    ari(0x02d4, 52, 55, 0),   ari(0x025c, 53, 56, 0),
    ari(0x01f8, 54, 57, 0),   ari(0x01a4, 55, 58, 0),
    ari(0x0160, 56, 59, 0),   ari(0x0125, 57, 60, 0),
    ari(0x00f6, 58, 61, 0),   ari(0x00cb, 59, 62, 0),
    ari(0x00ab, 61, 63, 0),   ari(0x008f, 61, 32, 0),
    ari(0x5b12, 65, 65, 1),   ari(0x4d04, 80, 66, 0),
    ari(0x412c, 81, 67, 0),   ari(0x37d8, 82, 68, 0),
    ari(0x2fe8, 83, 69, 0),   ari(0x293c, 84, 70, 0),
    ari(0x2379, 86, 71, 0),   ari(0x1edf, 87, 72, 0),
    ari(0x1aa9, 87, 73, 0),   ari(0x174e, 72, 74, 0),
    ari(0x1424, 72, 75, 0),   ari(0x119c, 74, 76, 0),
    ari(0x0f6b, 74, 77, 0),   ari(0x0d51, 75, 78, 0),
    ari(0x0bb6, 77, 79, 0),   ari(0x0a40, 77, 48, 0),
    ari(0x5832, 80, 81, 1),   ari(0x4d1c, 88, 82, 0),
    ari(0x438e, 89, 83, 0),   ari(0x3bdd, 90, 84, 0),
    ari(0x34ee, 91, 85, 0),   ari(0x2eae, 92, 86, 0),
    ari(0x299a, 93, 87, 0),   ari(0x2516, 86, 71, 0),
    ari(0x5570, 88, 89, 1),   ari(0x4ca9, 95, 90, 0),
    ari(0x44d9, 96, 91, 0),   ari(0x3e22, 97, 92, 0),
    ari(0x3824, 99, 93, 0),   ari(0x32b4, 99, 94, 0),
    ari(0x2e17, 93, 86, 0),   ari(0x56a8, 95, 96, 1),
    ari(0x4f46, 101, 97, 0),  ari(0x47e5, 102, 98, 0),
    ari(0x41cf, 103, 99, 0),  ari(0x3c3d, 104, 100, 0),
    ari(0x375e, 99, 93, 0),   ari(0x5231, 105, 102, 0),
    ari(0x4c0f, 106, 103, 0), ari(0x4639, 107, 104, 0),
    ari(0x415e, 103, 99, 0),  ari(0x5627, 105, 106, 1),
    ari(0x50e7, 108, 107, 0), ari(0x4b85, 109, 103, 0),
    ari(0x5597, 110, 109, 0), ari(0x504f, 111, 107, 0),
    ari(0x5a10, 110, 111, 1), ari(0x5522, 112, 109, 0),
    ari(0x59eb, 112, 111, 1), ari(0x5a1d, 113, 113, 0)};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------------------
// Inverse DCTs: libjpeg-turbo's at every output size its decoder picks
// (jddctmgr.c). Each takes one block's quantized coefficients in natural
// order and its quantization table, and writes size x size samples.
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
// FIX(x) of jdct.h: x in CONST_BITS fixed point, rounded.
constexpr int64_t fix(double x) {
  return int64_t(x * (int64_t(1) << kConstBits) + 0.5);
}
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// jdmaster.c's range limit of an IDCT output (the table's wraparound).
inline uint8_t idct_limit(int64_t x) {
  int i = int(x & 1023);
  return uint8_t(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
}

using Idct = void (*)(const int16_t* coef, const uint16_t* q, uint8_t* out,
                      int stride);

// libjpeg-turbo's SIMD islow IDCT (jidctint-avx2.asm; SSE2 alike), which
// PIL's and the system's libjpeg-turbo run on x86-64 for every full-size
// block. It equals jidctint.c's wherever no value leaves its range; on
// coefficients that do (a damaged stream) it keeps its own arithmetic:
// dequantization and the sums in0 + in4, in0 - in4, in7 + in3, in5 + in1
// in 16-bit lanes that wrap, the products and the outputs in 32-bit lanes
// that wrap, pass 1 saturated to 16 bits (packssdw), pass 2 to 8 bits
// (packsswb) before the +128; and where rows 1-7 of the whole block are 0,
// pass 1 is the DC row shifted left by 2 in 16 bits (psllw, wrapping).
inline int16_t wrap16(int64_t x) { return int16_t(uint16_t(uint64_t(x))); }
inline int32_t wrap32(int64_t x) { return int32_t(uint32_t(uint64_t(x))); }
inline int16_t sat16(int32_t x) {
  return int16_t(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}

// One column or row of dodct: eight 16-bit inputs to eight 32-bit outputs
// (descaled by `shift`, wrapping as the lanes do).
void simd_dct8(const int16_t* in, int step, int shift, int32_t* out) {
  const int32_t in0 = in[0], in1 = in[step], in2 = in[2 * step],
                in3 = in[3 * step], in4 = in[4 * step], in5 = in[5 * step],
                in6 = in[6 * step], in7 = in[7 * step];
  const int32_t tmp3 = wrap32(int64_t(in2) * (F0541 + F0765) + in6 * F0541);
  const int32_t tmp2 = wrap32(int64_t(in2) * F0541 + in6 * (F0541 - F1847));
  const int32_t tmp0 = wrap32(int64_t(wrap16(in0 + in4)) << kConstBits);
  const int32_t tmp1 = wrap32(int64_t(wrap16(in0 - in4)) << kConstBits);
  const int32_t tmp10 = wrap32(int64_t(tmp0) + tmp3);
  const int32_t tmp13 = wrap32(int64_t(tmp0) - tmp3);
  const int32_t tmp11 = wrap32(int64_t(tmp1) + tmp2);
  const int32_t tmp12 = wrap32(int64_t(tmp1) - tmp2);
  const int32_t z3 = wrap16(in7 + in3), z4 = wrap16(in5 + in1);
  const int32_t z3p = wrap32(int64_t(z3) * (F1175 - F1961) + z4 * F1175);
  const int32_t z4p = wrap32(int64_t(z3) * F1175 + z4 * (F1175 - F0390));
  const int32_t o0 = wrap32(
      wrap32(int64_t(in7) * (F0298 - F0899) + in1 * -F0899) + int64_t(z3p));
  const int32_t o3 = wrap32(
      wrap32(int64_t(in7) * -F0899 + in1 * (F1501 - F0899)) + int64_t(z4p));
  const int32_t o1 = wrap32(
      wrap32(int64_t(in5) * (F2053 - F2562) + in3 * -F2562) + int64_t(z4p));
  const int32_t o2 = wrap32(
      wrap32(int64_t(in5) * -F2562 + in3 * (F3072 - F2562)) + int64_t(z3p));
  const int64_t round = int64_t(1) << (shift - 1);
  auto d = [&](int64_t a, int64_t b) {
    return int32_t(wrap32(wrap32(a + b) + round) >> shift);
  };
  out[0] = d(tmp10, o3);
  out[7] = d(tmp10, -int64_t(o3));
  out[1] = d(tmp11, o2);
  out[6] = d(tmp11, -int64_t(o2));
  out[2] = d(tmp12, o1);
  out[5] = d(tmp12, -int64_t(o1));
  out[3] = d(tmp13, o0);
  out[4] = d(tmp13, -int64_t(o0));
}

void idct_islow_simd(const int16_t* coef, const uint16_t* q, uint8_t* out,
                     int stride) {
  int16_t dq[64], ws[64];
  bool ac_zero = true;
  for (int k = 8; k < 64; ++k) ac_zero = ac_zero && coef[k] == 0;
  for (int k = 0; k < 64; ++k) dq[k] = wrap16(int64_t(coef[k]) * q[k]);
  if (ac_zero) {
    for (int c = 0; c < 8; ++c)
      for (int r = 0; r < 8; ++r)
        ws[8 * r + c] = wrap16(int64_t(dq[c]) * (1 << kPass1Bits));
  } else {
    int32_t o[8];
    for (int c = 0; c < 8; ++c) {
      simd_dct8(dq + c, 8, kConstBits - kPass1Bits, o);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = sat16(o[r]);
    }
  }
  int32_t o[8];
  for (int r = 0; r < 8; ++r) {
    simd_dct8(ws + 8 * r, 1, kConstBits + kPass1Bits + 3, o);
    uint8_t* row = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      const int v = sat16(o[c]);
      row[c] = uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    }
  }
}

// The reduced-size transforms of IJG jidctred.c (libjpeg 6b) for 4 x 4
// and 2 x 2 output, as libjpeg-turbo's SIMD code computes them on x86-64
// (jidctred-sse2.asm, which both the JAX loader's and PIL's libjpeg run):
// jidctred.c's sums, but the dequantization in 16-bit lanes that wrap
// (pmullw), the products and sums in 32-bit lanes that wrap (pmaddwd,
// paddd), pass 1's outputs saturated to 16 bits (packssdw) and pass 2's to
// 8 bits (packsswb) before the +128, where jidctred.c's range limit wraps
// around; and for 4 x 4, where rows 1-3 and 5-7 of the whole block are 0,
// pass 1 is row 0 shifted left by 2 in 16 bits (psllw, wrapping). They
// tell from jidctred.c only on a damaged stream. (The 2 x 2 keeps pass 1's
// column 0 in 32 bits, see below.) The 4 x 4 reads no
// coefficient of row or column 4, the 2 x 2 none of rows or columns 2, 4
// and 6.
constexpr int64_t R0211 = 1730, R0509 = 4176, R0601 = 4926, R0720 = 5906,
                  R0850 = 6967, R1061 = 8697, R1272 = 10426, R1451 = 11893,
                  R2172 = 17799, R3624 = 29692;

inline int8_t sat8(int32_t x) {
  return int8_t(x < -128 ? -128 : x > 127 ? 127 : x);
}
// x + the rounding of a right shift by n, in a 32-bit lane, then shifted
inline int32_t simd_descale(int64_t x, int n) {
  return wrap32(wrap32(x) + (int64_t(1) << (n - 1))) >> n;
}

// One column or row of the 4-point transform: 16-bit inputs x(0..7) (x(4)
// unread) to four 32-bit sums before their shift.
template <class X>
void simd_red4(X x, int64_t* o) {
  const int64_t tmp0 = int64_t(x(0)) * (1 << (kConstBits + 1));
  const int64_t tmp2 = x(2) * F1847 + x(6) * -F0765;
  const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
  const int64_t z1 = x(7), z2 = x(5), z3 = x(3), z4 = x(1);
  const int64_t t0 = z1 * -R0211 + z2 * R1451 + z3 * -R2172 + z4 * R1061;
  const int64_t t2 = z1 * -R0509 + z2 * -R0601 + z3 * F0899 + z4 * F2562;
  o[0] = tmp10 + t2;
  o[3] = tmp10 - t2;
  o[1] = tmp12 + t0;
  o[2] = tmp12 - t0;
}

void idct_4x4(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  int16_t dq[64], ws[4 * 8] = {};
  bool ac_zero = true;
  for (int k = 8; k < 64; ++k) {
    if (k >= 32 && k < 40) continue;   // row 4: not read
    dq[k] = wrap16(int64_t(in[k]) * q[k]);
    ac_zero = ac_zero && in[k] == 0;
  }
  for (int k = 0; k < 8; ++k) dq[k] = wrap16(int64_t(in[k]) * q[k]);
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;   // column 4: not read in pass 2
    if (ac_zero) {
      for (int r = 0; r < 4; ++r) ws[8 * r + c] = wrap16(int64_t(dq[c]) << 2);
      continue;
    }
    if (!dq[8 + c] && !dq[16 + c] && !dq[24 + c] && !dq[40 + c] &&
        !dq[48 + c] && !dq[56 + c]) {   // the sums below, with no AC term
      for (int r = 0; r < 4; ++r) ws[8 * r + c] = sat16(dq[c] * 4);
      continue;
    }
    int64_t o[4];
    simd_red4([&](int r) { return dq[8 * r + c]; }, o);
    for (int r = 0; r < 4; ++r)
      ws[8 * r + c] =
          sat16(simd_descale(o[r], kConstBits - kPass1Bits + 1));
  }
  for (int r = 0; r < 4; ++r) {
    int64_t o[4];
    simd_red4([&](int i) { return ws[8 * r + i]; }, o);
    for (int c = 0; c < 4; ++c)
      out[r * stride + c] = uint8_t(sat8(sat16(simd_descale(
          o[c], kConstBits + kPass1Bits + 3 + 1))) + 128);
  }
}

// One column or row of the 2-point transform: its two sums before their
// shift.
template <class X>
void simd_red2(X x, int64_t* o) {
  const int64_t tmp10 = int64_t(x(0)) * (1 << (kConstBits + 2));
  const int64_t tmp0 =
      x(7) * -R0720 + x(5) * R0850 + x(3) * -R1272 + x(1) * R3624;
  o[0] = tmp10 + tmp0;
  o[1] = tmp10 - tmp0;
}

void idct_2x2(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  int16_t dq[64];
  int32_t ws[2 * 8] = {};
  for (int k = 0; k < 64; ++k) dq[k] = wrap16(int64_t(in[k]) * q[k]);
  for (int c : {0, 1, 3, 5, 7}) {
    int64_t o[2];
    simd_red2([&](int r) { return int64_t(dq[8 * r + c]); }, o);
    for (int r = 0; r < 2; ++r) {
      const int32_t v = simd_descale(o[r], kConstBits - kPass1Bits + 2);
      ws[8 * r + c] = c ? sat16(v) : v;
    }
  }
  for (int r = 0; r < 2; ++r) {
    int64_t o[2];
    // column 0 stays in its 32-bit lane: pass 2 shifts it left as it is
    // (pslld), wrapping, where the odd columns were packed to 16 bits
    simd_red2([&](int i) {
      return i ? int64_t(ws[8 * r + i])
               : int64_t(wrap32(int64_t(ws[8 * r]) << (kConstBits + 2))) >>
                     (kConstBits + 2);
    }, o);
    for (int c = 0; c < 2; ++c)
      out[r * stride + c] = uint8_t(sat8(sat16(simd_descale(
          o[c], kConstBits + kPass1Bits + 3 + 2))) + 128);
  }
}

// jidctred.c's 1 x 1 (C in libjpeg-turbo too): the DC term alone, with the
// range limit's wraparound. libjpeg's multiplier tables are 16-bit
// (ISLOW_MULT_TYPE), as the quantizer is taken here and below.
void idct_1x1(const int16_t* in, const uint16_t* q, uint8_t* out, int) {
  out[0] = idct_limit(descale(int32_t(in[0]) * int16_t(q[0]), 3));
}


// IJG jidctint.c's scaled routines (libjpeg 7+) for N = 3, 5, 6, 7, 10, 12
// and 14. Each is one N-point transform, `points`, run on the columns
// (pass 1) and then on the work array's rows (pass 2): x(i) is input i,
// `base` x(0) << CONST_BITS with the rounding for the pass's final shift
// added ("fudge factor"), and y(i, v) takes output i before its shift.
// Below 8 the transform reads the first N coefficients of each column and
// row, above 8 all 8. (Where jidctint.c's pass 1 shifts a term earlier,
// that term is a multiple of the shift's unit, so the result is the same.)
template <int N, class Points>
void idct_scaled(const int16_t* in, const uint16_t* q, uint8_t* out,
                 int stride, Points points) {
  constexpr int K = N < 8 ? N : 8;
  int ws[K * N];
  for (int c = 0; c < K; ++c) {
    auto x = [&](int r) {
      return int64_t(int32_t(in[8 * r + c]) * int16_t(q[8 * r + c]));
    };
    points(x, x(0) * (1 << kConstBits) +
                  (int64_t(1) << (kConstBits - kPass1Bits - 1)),
           [&](int i, int64_t v) {
             ws[K * i + c] = int(v >> (kConstBits - kPass1Bits));
           });
  }
  for (int r = 0; r < N; ++r) {
    const int* w = ws + K * r;
    uint8_t* o = out + r * stride;
    points([&](int i) { return int64_t(w[i]); },
           (int64_t(w[0]) + (int64_t(1) << (kPass1Bits + 2))) *
               (1 << kConstBits),
           [&](int i, int64_t v) {
             o[i] = idct_limit(v >> (kConstBits + kPass1Bits + 3));
           });
  }
}

constexpr int64_t kOne = int64_t(1) << kConstBits;

void idct_3x3(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  idct_scaled<3>(in, q, out, stride, [](auto x, int64_t base, auto y) {
    const int64_t t12 = x(2) * fix(0.707106781);           // c2
    const int64_t t10 = base + t12, t2 = base - t12 - t12;
    const int64_t t0 = x(1) * fix(1.224744871);            // c1
    y(0, t10 + t0);
    y(2, t10 - t0);
    y(1, t2);
  });
}

void idct_5x5(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  idct_scaled<5>(in, q, out, stride, [](auto x, int64_t base, auto y) {
    int64_t t12 = base, t0 = x(2), t1 = x(4);
    int64_t z1 = (t0 + t1) * fix(0.790569415);             // (c2+c4)/2
    int64_t z2 = (t0 - t1) * fix(0.353553391);             // (c2-c4)/2
    int64_t z3 = t12 + z2;
    const int64_t t10 = z3 + z1, t11 = z3 - z1;
    t12 -= z2 * 4;
    z2 = x(1);
    z3 = x(3);
    z1 = (z2 + z3) * fix(0.831253876);                     // c3
    t0 = z1 + z2 * fix(0.513743148);                       // c1-c3
    t1 = z1 - z3 * fix(2.176250899);                       // c1+c3
    y(0, t10 + t0);
    y(4, t10 - t0);
    y(1, t11 + t1);
    y(3, t11 - t1);
    y(2, t12);
  });
}

void idct_6x6(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  idct_scaled<6>(in, q, out, stride, [](auto x, int64_t base, auto y) {
    int64_t t10 = x(4) * fix(0.707106781);                 // c4
    int64_t t1 = base + t10;
    const int64_t t11 = base - t10 - t10;
    int64_t t0 = x(2) * fix(1.224744871);                  // c2
    t10 = t1 + t0;
    const int64_t t12 = t1 - t0;
    const int64_t z1 = x(1), z2 = x(3), z3 = x(5);
    t1 = (z1 + z3) * fix(0.366025404);                     // c5
    t0 = t1 + (z1 + z2) * kOne;
    const int64_t t2 = t1 + (z3 - z2) * kOne;
    t1 = (z1 - z2 - z3) * kOne;
    y(0, t10 + t0);
    y(5, t10 - t0);
    y(1, t11 + t1);
    y(4, t11 - t1);
    y(2, t12 + t2);
    y(3, t12 - t2);
  });
}

void idct_7x7(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  idct_scaled<7>(in, q, out, stride, [](auto x, int64_t base, auto y) {
    int64_t t13 = base;
    int64_t z1 = x(2), z2 = x(4), z3 = x(6);
    int64_t t10 = (z2 - z3) * fix(0.881747734);            // c4
    int64_t t12 = (z1 - z2) * fix(0.314692123);            // c6
    const int64_t t11 = t10 + t12 + t13 - z2 * fix(1.841218003);
    int64_t t0 = z1 + z3;
    z2 -= t0;
    t0 = t0 * fix(1.274162392) + t13;                      // c2
    t10 += t0 - z3 * fix(0.077722536);                     // c2-c4-c6
    t12 += t0 - z1 * fix(2.470602249);                     // c2+c4+c6
    t13 += z2 * fix(1.414213562);                          // c0
    z1 = x(1);
    z2 = x(3);
    z3 = x(5);
    int64_t t1 = (z1 + z2) * fix(0.935414347);             // (c3+c1-c5)/2
    int64_t t2 = (z1 - z2) * fix(0.170262339);             // (c3+c5-c1)/2
    t0 = t1 - t2;
    t1 += t2;
    t2 = (z2 + z3) * -fix(1.378756276);                    // -c1
    t1 += t2;
    z2 = (z1 + z3) * fix(0.613604268);                     // c5
    t0 += z2;
    t2 += z2 + z3 * fix(1.870828693);                      // c3+c1-c5
    y(0, t10 + t0);
    y(6, t10 - t0);
    y(1, t11 + t1);
    y(5, t11 - t1);
    y(2, t12 + t2);
    y(4, t12 - t2);
    y(3, t13);
  });
}

void idct_10x10(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  idct_scaled<10>(in, q, out, stride, [](auto x, int64_t base, auto y) {
    int64_t z3 = base, z4 = x(4);
    int64_t z1 = z4 * fix(1.144122806);                    // c4
    int64_t z2 = z4 * fix(0.437016024);                    // c8
    int64_t t10 = z3 + z1, t11 = z3 - z2;
    const int64_t t22 = z3 - (z1 - z2) * 2;                // c0 = (c4-c8)*2
    z2 = x(2);
    z3 = x(6);
    z1 = (z2 + z3) * fix(0.831253876);                     // c6
    int64_t t12 = z1 + z2 * fix(0.513743148);              // c2-c6
    int64_t t13 = z1 - z3 * fix(2.176250899);              // c2+c6
    const int64_t t20 = t10 + t12, t24 = t10 - t12;
    const int64_t t21 = t11 + t13, t23 = t11 - t13;
    z1 = x(1);
    z2 = x(3);
    z3 = x(5) * kOne;
    z4 = x(7);
    t11 = z2 + z4;
    t13 = z2 - z4;
    t12 = t13 * fix(0.309016994);                          // (c3-c7)/2
    z2 = t11 * fix(0.951056516);                           // (c3+c7)/2
    z4 = z3 + t12;
    t10 = z1 * fix(1.396802247) + z2 + z4;                 // c1
    const int64_t t14 = z1 * fix(0.221231742) - z2 + z4;   // c9
    z2 = t11 * fix(0.587785252);                           // (c1-c9)/2
    z4 = z3 - t12 - t13 * (kOne / 2);
    t12 = (z1 - t13) * kOne - z3;
    t11 = z1 * fix(1.260073511) - z2 - z4;                 // c3
    t13 = z1 * fix(0.642039522) - z2 + z4;                 // c7
    y(0, t20 + t10);
    y(9, t20 - t10);
    y(1, t21 + t11);
    y(8, t21 - t11);
    y(2, t22 + t12);
    y(7, t22 - t12);
    y(3, t23 + t13);
    y(6, t23 - t13);
    y(4, t24 + t14);
    y(5, t24 - t14);
  });
}

void idct_12x12(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  idct_scaled<12>(in, q, out, stride, [](auto x, int64_t base, auto y) {
    int64_t z3 = base;
    int64_t z4 = x(4) * fix(1.224744871);                  // c4
    const int64_t t10 = z3 + z4, t11 = z3 - z4;
    int64_t z1 = x(2);
    z4 = z1 * fix(1.366025404);                            // c2
    z1 *= kOne;
    int64_t z2 = x(6) * kOne;
    int64_t t12 = z1 - z2;
    const int64_t t21 = z3 + t12, t24 = z3 - t12;
    t12 = z4 + z2;
    const int64_t t20 = t10 + t12, t25 = t10 - t12;
    t12 = z4 - z1 - z2;
    const int64_t t22 = t11 + t12, t23 = t11 - t12;
    z1 = x(1);
    z2 = x(3);
    z3 = x(5);
    z4 = x(7);
    int64_t o11 = z2 * fix(1.306562965);                   // c3
    int64_t o14 = z2 * -F0541;                             // -c9
    int64_t o10 = z1 + z3;
    int64_t o15 = (o10 + z4) * fix(0.860918669);           // c7
    int64_t o12 = o15 + o10 * fix(0.261052384);            // c5-c7
    o10 = o12 + o11 + z1 * fix(0.280143716);               // c1-c5
    int64_t o13 = (z3 + z4) * -fix(1.045510580);           // -(c7+c11)
    o12 += o13 + o14 - z3 * fix(1.478575242);              // c1+c5-c7-c11
    o13 += o15 - o11 + z4 * fix(1.586706681);              // c1+c11
    o15 += o14 - z1 * fix(0.676326758) - z4 * fix(1.982889723);
    z1 -= z4;
    z2 -= z3;
    z3 = (z1 + z2) * F0541;                                // c9
    o11 = z3 + z1 * F0765;                                 // c3-c9
    o14 = z3 - z2 * F1847;                                 // c3+c9
    y(0, t20 + o10);
    y(11, t20 - o10);
    y(1, t21 + o11);
    y(10, t21 - o11);
    y(2, t22 + o12);
    y(9, t22 - o12);
    y(3, t23 + o13);
    y(8, t23 - o13);
    y(4, t24 + o14);
    y(7, t24 - o14);
    y(5, t25 + o15);
    y(6, t25 - o15);
  });
}

void idct_14x14(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  idct_scaled<14>(in, q, out, stride, [](auto x, int64_t base, auto y) {
    int64_t z1 = base, z4 = x(4);
    int64_t z2 = z4 * fix(1.274162392);                    // c4
    int64_t z3 = z4 * fix(0.314692123);                    // c12
    z4 *= fix(0.881747734);                                // c8
    const int64_t t10 = z1 + z2, t11 = z1 + z3, t12 = z1 - z4;
    const int64_t t23 = z1 - (z2 + z3 - z4) * 2;           // c0
    z1 = x(2);
    z2 = x(6);
    z3 = (z1 + z2) * fix(1.105676686);                     // c6
    const int64_t t13 = z3 + z1 * fix(0.273079590);        // c2-c6
    const int64_t t14 = z3 - z2 * fix(1.719280954);        // c6+c10
    const int64_t t15 = z1 * fix(0.613604268) - z2 * fix(1.378756276);
    const int64_t t20 = t10 + t13, t26 = t10 - t13;
    const int64_t t21 = t11 + t14, t25 = t11 - t14;
    const int64_t t22 = t12 + t15, t24 = t12 - t15;
    z1 = x(1);
    z2 = x(3);
    z3 = x(5);
    z4 = x(7) * kOne;
    int64_t o14 = z1 + z3;
    int64_t o11 = (z1 + z2) * fix(1.334852607);            // c3
    int64_t o12 = o14 * fix(1.197448846);                  // c5
    const int64_t o10 = o11 + o12 + z4 - z1 * fix(1.126980169);
    o14 *= fix(0.752406978);                               // c9
    int64_t o16 = o14 - z1 * fix(1.061150426);             // c9+c11-c13
    z1 -= z2;
    int64_t o15 = z1 * fix(0.467085129) - z4;              // c11
    o16 += o15;
    int64_t o13 = (z2 + z3) * -fix(0.158341681) - z4;      // -c13
    o11 += o13 - z2 * fix(0.424103948);                    // c3-c9-c13
    o12 += o13 - z3 * fix(2.373959773);                    // c3+c5-c13
    o13 = (z3 - z2) * fix(1.405321284);                    // c1
    o14 += o13 + z4 - z3 * fix(1.6906431334);              // c1+c9-c11
    o15 += o13 + z2 * fix(0.674957567);                    // c1+c11-c5
    o13 = (z1 - z3) * kOne + z4;
    y(0, t20 + o10);
    y(13, t20 - o10);
    y(1, t21 + o11);
    y(12, t21 - o11);
    y(2, t22 + o12);
    y(11, t22 - o12);
    y(3, t23 + o13);
    y(10, t23 - o13);
    y(4, t24 + o14);
    y(9, t24 - o14);
    y(5, t25 + o15);
    y(8, t25 - o15);
    y(6, t26 + o16);
    y(7, t26 - o16);
  });
}

// The IDCT libjpeg-turbo's jddctmgr.c picks for an output block of
// `size` x `size` samples.
Idct idct_of_size(int size) {
  switch (size) {
    case 1: return idct_1x1;
    case 2: return idct_2x2;
    case 3: return idct_3x3;
    case 4: return idct_4x4;
    case 5: return idct_5x5;
    case 6: return idct_6x6;
    case 7: return idct_7x7;
    case 8: return idct_islow_simd;
    case 10: return idct_10x10;
    case 12: return idct_12x12;
    case 14: return idct_14x14;
    default: fail("no IDCT of size " + std::to_string(size));
  }
}

// The coefficients that libjpeg's block smoothing (jdcoefct.c
// smoothing_ok) looks at: zigzag positions 0 to 9.
constexpr int kSmoothCoefs = 10;

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;   // the current scan's table selectors
  int dc_pred = 0;
  int dc_context = 0;   // arithmetic coding's DC conditioning (jdarith.c)
  int width = 0, height = 0;   // downsampled size (jdiv_round_up)
  int bw = 0, bh = 0; // its blocks: ceil(width / 8) x ceil(height / 8)
  int bh_pad = 0;     // block rows of the coefficient buffer
  // The quantization table latched at the component's first scan (jdinput.c
  // latch_quant_tables), natural order.
  uint16_t q[64] = {};
  bool latched = false;
  // Per zigzag coefficient, the lowest bit decoded so far; -1: none yet
  // (libjpeg's coef_bits); and the same before the component's latest scan
  // (libjpeg-turbo's second half of coef_bits), which block smoothing
  // takes for the iMCU rows past the last that a scan decoded with data.
  int8_t coef_bits[64];
  int8_t prev_bits[64];
  // Frames of more than one scan (progressive, or sequential with a
  // component in a scan of its own): every block's quantized coefficients,
  // natural order, bw * bh_pad blocks of 64, kept until all scans are read.
  std::vector<int16_t> coef;
  // The decode's output: IDCT size, downsampled size at that scale, and the
  // plane of its samples (bw * size x bh * size; a lossless frame's: width
  // x height).
  int size = 8, out_w = 0, out_h = 0, stride = 0;
  Idct idct = nullptr;
  std::vector<uint8_t> plane;

  Component() {
    std::memset(coef_bits, -1, sizeof(coef_bits));
    std::memset(prev_bits, 0, sizeof(prev_bits));
  }

  int16_t* block(int bx, int by) {
    return coef.data() + (size_t(by) * bw + bx) * 64;
  }
  void emit(int bx, int by, const int16_t* coefs) {
    idct(coefs, q, plane.data() + size_t(by) * size * stride + bx * size,
         stride);
  }
};

// One block of an MCU, in libjpeg's order (jdcoefct.c).
struct Unit {
  Component* c;
  int bx, by;
};

struct Decoder {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;
  int scale = 8;            // the output is scale / 8 of the frame's size
  uint16_t qt[4][64] = {};  // natural order
  bool qt_present[4] = {};
  int qt_prec[4] = {};
  // each defined Huffman table's DHT payload (class, id), for tables()
  std::vector<uint8_t> dht_raw[2][4];
  // libtiff's JPEG codec: a frame whose first scan codes every component
  // (no buffered image) is read to that scan's end only, as
  // jpeg_read_scanlines reads it; the markers after go unread
  bool stop_after_scan = false;
  bool scanned = false;

  // ---- the data source and the markers (jdmarker.c) ----
  End end = End::kSuspend;
  // the bytes the source holds: kSuspend, those ImageFile.load has handed
  // over so far; kFakeEoi, all of them
  size_t limit = 0;
  bool header_only = false;  // reading to the frame header alone
  int unread_marker = 0;     // a marker read but not yet processed
  int next_restart_num = 0;
  int scan_number = 0;       // libjpeg's input_scan_number
  bool multi_scan = false;   // has_multiple_scans, set at the first scan
  // a single-scan frame's every MCU decoded: libjpeg has then output
  // every row, and PIL keeps them whatever the markers after do
  bool rows_done = false;
  // the last iMCU row a scan reached with data (master->last_good_iMCU_row)
  int last_good_imcu = 0;
  // The Huffman decoders' bit buffer (jdhuff.h): the low bits_left bits
  // of get_buffer are the next ones; insufficient is the entropy decoder's
  // insufficient_data (the scan met a marker and ran out of bits).
  uint64_t get_buffer = 0;
  int bits_left = 0;
  bool insufficient = false;
  // The arithmetic decoder's registers (jdarith.c): C with the bits read
  // ahead, A, and CT the shift between them, -1 after a coding error.
  int64_t ar_c = 0, ar_a = 0;
  int ar_ct = -16;

  // One byte of the data, as the source hands it over.
  int byte() {
    if (pos < limit) return data[pos++];
    if (limit < size) {   // kSuspend, short of the end: the next block
      limit = std::min(size, limit + kPilBlock);
      return data[pos++];
    }
    if (end == End::kFakeEoi) return (pos++ - size) & 1 ? 0xD9 : 0xFF;
    throw Suspended{};
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  // skip_input_data: a segment's rest, past the end into the fake EOIs.
  void skip(long n) {
    if (n <= 0) return;
    pos += size_t(n);
    if (pos > limit) {
      if (end == End::kSuspend && pos > size) throw Suspended{};
      limit = std::min(size, (pos + kPilBlock - 1) / kPilBlock * kPilBlock);
    }
  }

  // next_marker: the next marker, any other bytes before it skipped
  // (libjpeg warns of them), fill bytes and stuffed FF 00 included.
  void next_marker() {
    int c;
    for (;;) {
      c = byte();
      while (c != 0xFF) c = byte();
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) break;
    }
    unread_marker = c;
  }

  // read_restart_marker, and jpeg_resync_to_restart where the marker met
  // is not the RSTn expected: another marker, or an RSTn that is one of
  // the next two, stays unread (the interval then decodes from no data);
  // a marker below SOF0 or an RSTn one or two behind is passed over for
  // the next; any other RSTn is taken for the expected one.
  void read_restart_marker() {
    if (unread_marker == 0) next_marker();
    const int want = next_restart_num;
    if (unread_marker == 0xD0 + want) {
      unread_marker = 0;
    } else {
      for (;;) {
        const int m = unread_marker;
        int action;
        if (m < 0xC0)
          action = 2;
        else if (m < 0xD0 || m > 0xD7)
          action = 3;
        else if (m == 0xD0 + ((want + 1) & 7) || m == 0xD0 + ((want + 2) & 7))
          action = 3;
        else if (m == 0xD0 + ((want - 1) & 7) || m == 0xD0 + ((want - 2) & 7))
          action = 2;
        else
          action = 1;
        if (action == 1) unread_marker = 0;
        if (action != 2) break;
        next_marker();
      }
    }
    next_restart_num = (next_restart_num + 1) & 7;
  }

  // ---- Huffman-coded bits (jdhuff.h, jdhuff.c) ----

  // jpeg_fill_bit_buffer: at least kMinGetBits bits read ahead, unless a
  // marker stops the reading; where nbits are then wanted beyond what is
  // left, zeros stand in for them and the data counts as run out.
  void fill_bits(int nbits) {
    if (unread_marker == 0) {
      while (bits_left < kMinGetBits) {
        int c = byte();
        if (c == 0xFF) {
          do {
            c = byte();
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            break;
          }
        }
        get_buffer = (get_buffer << 8) | uint64_t(c);
        bits_left += 8;
      }
      if (unread_marker == 0) return;
    }
    if (nbits > bits_left) {
      insufficient = true;
      get_buffer <<= kMinGetBits - bits_left;
      bits_left = kMinGetBits;
    }
  }
  void check_bits(int n) {
    if (bits_left < n) fill_bits(n);
  }
  int get_bits(int n) {
    bits_left -= n;
    return int((get_buffer >> bits_left) & ((uint64_t(1) << n) - 1));
  }
  // HUFF_DECODE and jpeg_huff_decode: a code of up to 16 bits; a garbage
  // one reaches 17 bits and reads as 0, as libjpeg warns and fakes it.
  int huff_decode(const DecHuff& h) {
    int nb = 1;
    if (bits_left < kLookahead) {
      fill_bits(0);
    }
    if (bits_left >= kLookahead) {
      const int look =
          int(get_buffer >> (bits_left - kLookahead)) & ((1 << kLookahead) - 1);
      nb = h.lookup[look] >> kLookahead;
      if (nb <= kLookahead) {
        bits_left -= nb;
        return h.lookup[look] & 0xFF;
      }
    }
    if (bits_left >= 17) {   // no fill comes: the code read at once
      const int32_t top = int32_t(get_buffer >> (bits_left - 16)) & 0xFFFF;
      for (; nb <= 16; ++nb) {
        const int32_t code = top >> (16 - nb);
        if (code <= h.maxcode[nb]) {
          bits_left -= nb;
          return h.vals[(code + h.valoffset[nb]) & 0xFF];
        }
      }
      bits_left -= 17;
      return 0;
    }
    check_bits(nb);
    int32_t code = get_bits(nb);
    while (code > h.maxcode[nb]) {
      code <<= 1;
      check_bits(1);
      code |= get_bits(1);
      ++nb;
    }
    if (nb > 16) return 0;
    return h.vals[(code + h.valoffset[nb]) & 0xFF];
  }
  // FILL_BIT_BUFFER_FAST: six bytes where 16 bits or fewer are left, with
  // no check of the data's end (the caller made sure of 512 bytes a block);
  // a marker stuffs zeros and is left unread.
  void fill_fast() {
    if (bits_left > 16) return;
    for (int i = 0; i < 6; ++i) {
      const int c0 = data[pos++], c1 = data[pos];
      get_buffer = (get_buffer << 8) | uint64_t(c0);
      bits_left += 8;
      if (c0 == 0xFF) {
        ++pos;
        if (c1 != 0) {
          unread_marker = c1;
          pos -= 2;
          get_buffer &= ~uint64_t(0xFF);
        }
      }
    }
  }
  // HUFF_DECODE_FAST
  int huff_decode_fast(const DecHuff& h) {
    fill_fast();
    int s = h.lookup[(get_buffer >> (bits_left - kLookahead)) & 0xFF];
    int nb = s >> kLookahead;
    bits_left -= nb;
    s &= 0xFF;
    if (nb > kLookahead) {
      s = int((get_buffer >> bits_left) & ((uint64_t(1) << nb) - 1));
      while (s > h.maxcode[nb]) {
        s = (s << 1) | get_bits(1);
        ++nb;
      }
      s = nb > 16 ? 0 : h.vals[(s + h.valoffset[nb]) & 0xFF];
    }
    return s;
  }
  // An entropy decoder's restart (process_restart): the bits read ahead
  // dropped, the RSTn read (or resynced), and the data counted as there
  // again unless a marker is still unread.
  void huff_restart() {
    bits_left = 0;
    read_restart_marker();
    if (unread_marker == 0) insufficient = false;
  }

  // ---- arithmetic-coded data (jdarith.c) ----

  // get_byte and arith_decode's marker handling: a marker ends the data,
  // zeros are fed from there (legal in arithmetic coding). libjpeg's
  // arithmetic decoder cannot suspend: where PIL's source would, the
  // decode fails (an arithmetic-coded scan whose data crosses one of
  // ImageFile.load's blocks, or is cut short).
  int arith_byte() {
    auto next = [&] {
      if (pos >= limit && end == End::kSuspend)
        fail("corrupt JPEG data: libjpeg's arithmetic decoder cannot "
             "suspend (its data is cut short or crosses PIL's 64 KiB "
             "read)");
      return byte();
    };
    int c = next();
    if (c == 0xFF) {
      do {
        c = next();
      } while (c == 0xFF);
      if (c == 0) return 0xFF;
      unread_marker = c;
      return 0;
    }
    return c;
  }
  // One binary decision with the adaptive estimate *st (bit 7: the MPS).
  int arith_decode(uint8_t* st) {
    while (ar_a < 0x8000) {
      if (--ar_ct < 0) {
        const int b = unread_marker ? 0 : arith_byte();
        ar_c = (ar_c << 8) | b;
        if ((ar_ct += 8) < 0 && ++ar_ct == 0) ar_a = 0x8000;  // 2 first bytes
      }
      ar_a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = int(qe & 0xFF);
    qe >>= 8;
    const int nm = int(qe & 0xFF);
    qe >>= 8;
    int64_t temp = ar_a - qe;
    ar_a = temp;
    temp <<= ar_ct;
    if (ar_c >= temp) {
      ar_c -= temp;
      if (ar_a < qe) {          // conditional exchange: this was the MPS
        ar_a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        ar_a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ar_a < 0x8000) {
      if (ar_a < qe) {          // conditional exchange: this was the LPS
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // The decoder's tables as a tables-only stream (SOI, DQT, DHT, EOI):
  // what libjpeg keeps from one image to the next.
  std::vector<uint8_t> tables() const {
    std::vector<uint8_t> o = {0xFF, 0xD8};
    for (int t = 0; t < 4; ++t) {
      if (!qt_present[t]) continue;
      const int n = 64 * (qt_prec[t] ? 2 : 1);
      o.insert(o.end(), {0xFF, 0xDB, uint8_t((n + 3) >> 8),
                         uint8_t((n + 3) & 255), uint8_t(qt_prec[t] << 4 | t)});
      for (int i = 0; i < 64; ++i) {
        const uint16_t v = qt[t][kNatural[i]];
        if (qt_prec[t]) o.push_back(uint8_t(v >> 8));
        o.push_back(uint8_t(v & 255));
      }
    }
    for (int tc = 0; tc < 2; ++tc) {
      for (int th = 0; th < 4; ++th) {
        const std::vector<uint8_t>& r = dht_raw[tc][th];
        if (r.empty()) continue;
        const size_t n = r.size() + 1;
        o.insert(o.end(), {0xFF, 0xC4, uint8_t((n + 2) >> 8),
                           uint8_t((n + 2) & 255), uint8_t(tc << 4 | th)});
        o.insert(o.end(), r.begin(), r.end());
      }
    }
    o.insert(o.end(), {0xFF, 0xD9});
    return o;
  }
  DecHuff dc[4], ac[4];
  std::vector<Component> comps;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool frame = false, progressive = false, jfif = false, adobe = false;
  bool arithmetic = false, lossless = false;
  int adobe_transform = -1;
  // Block smoothing's edges as libjpeg-turbo 3 (PIL's) or 2.1 (the JAX
  // loader's) takes them (emit_smoothed).
  bool turbo3 = true;
  // The colour conversion: kColourPil as PIL's convert("RGB") takes it;
  // kColourYcc YCbCr to RGB whatever the markers say, and kColourRaw the
  // components as stored (one to four a pixel), libtiff's
  // JPEGCOLORMODE_RGB and JCS_UNKNOWN.
  int colour = kColourPil;
  // The DAC segment's conditioning (jdmarker.c get_dac; libjpeg's defaults
  // L = 0, U = 1, K = 5) and the arithmetic decoder's statistics bins.
  uint8_t dac_l[16], dac_u[16], dac_k[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];

  Decoder() {
    std::memset(dac_l, 0, sizeof(dac_l));
    std::memset(dac_u, 1, sizeof(dac_u));
    std::memset(dac_k, 5, sizeof(dac_k));
  }

  // ---- marker segments (jdmarker.c get_*), read through the source ----

  void read_dqt() {
    long length = u16() - 2;
    while (length > 0) {
      const int n = byte(), t = n & 15, prec = n >> 4;
      if (t > 3) fail("bad DQT segment: table " + std::to_string(t));
      for (int i = 0; i < 64; ++i)
        qt[t][kNatural[i]] = uint16_t(prec ? u16() : byte());
      qt_present[t] = true;
      qt_prec[t] = prec ? 1 : 0;
      length -= 64 + 1 + (prec ? 64 : 0);
    }
    // the tables must fill the segment exactly
    if (length != 0) fail("bad DQT segment length");
  }

  void read_dht() {
    long length = u16() - 2;
    while (length > 16) {
      const int index = byte();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += bits[l] = uint8_t(byte());
      length -= 1 + 16;
      if (count > 256 || count > length) fail("bad DHT segment");
      uint8_t vals[256];
      for (int i = 0; i < count; ++i) vals[i] = uint8_t(byte());
      length -= count;
      const int tc = index >> 4, th = index & 15;
      if (tc > 1 || th > 3) fail("bad DHT segment: table " +
                                 std::to_string(index));
      (tc ? ac : dc)[th].define(bits, vals, count);
      dht_raw[tc][th].assign(bits + 1, bits + 17);
      dht_raw[tc][th].insert(dht_raw[tc][th].end(), vals, vals + count);
    }
    if (length != 0) fail("bad DHT segment length");
  }

  void read_sof(int marker) {
    if (frame) fail("more than one frame");
    progressive = marker == 0xC2 || marker == 0xCA;
    arithmetic = marker == 0xC9 || marker == 0xCA;
    lossless = marker == 0xC3;
    const long length = u16();
    const int precision = byte();
    height = u16();
    width = u16();
    const int n = byte();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG (SOF" +
           std::to_string(marker - 0xC0) + ") is not supported");
    if (width <= 0 || height <= 0)
      fail("JPEG without its size in the frame header (DNL) is not "
           "supported");
    // the segment holds the components, exactly
    if (length - 8 != n * 3) fail("bad SOF segment length");
    if (n != 1 && n != 3 && n != 4)
      fail(std::to_string(n) + "-component JPEG is not supported");
    comps.resize(n);
    for (int k = 0; k < n; ++k) {
      Component& c = comps[k];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad SOF segment");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (int64_t(width) * height > kMaxPixels)
      fail("JPEG of " + std::to_string(width) + "x" + std::to_string(height) +
           " pixels is above the limit of " + std::to_string(kMaxPixels) +
           " (a decompression bomb)");
    // A lossless frame's data unit is one sample, a DCT frame's a block.
    const int unit = lossless ? 1 : 8;
    mcus_x = (width + unit * hmax - 1) / (unit * hmax);
    mcus_y = (height + unit * vmax - 1) / (unit * vmax);
    // Every data unit of every component is coded. Huffman-coded, a
    // sequential block takes 2 bits at the least (a 1-bit DC code and a
    // 1-bit EOB), so a file of `size` bytes holds at most 4 * size of them;
    // a progressive frame's first DC scan still codes each block in 1 bit
    // at the least, and a lossless frame each sample (8 * size). An
    // arithmetic-coded decision can take far less than a bit: those frames
    // are bounded by the pixel limit alone. (A request body is held to
    // this; a file the loader reads is not, as libjpeg reads the blocks
    // past a cut as zeros.)
    int64_t units = 0;
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        fail("unsupported chroma sampling");
      c.width = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.height = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.bw = (c.width + unit - 1) / unit;
      c.bh = (c.height + unit - 1) / unit;
      units += int64_t(c.bw) * c.bh;
    }
    if (!arithmetic && end == End::kSuspend && !header_only &&
        units > (progressive || lossless ? 8 : 4) * int64_t(size))
      fail("corrupt JPEG data: " + std::to_string(size) + " bytes cannot "
           "hold a " + std::to_string(width) + "x" + std::to_string(height) +
           " frame");
    // A progressive frame keeps every coefficient until its last scan:
    // no more of them than its components have samples at the pixel limit.
    if (progressive) check_coefficient_buffer(units);
    frame = true;
  }

  void check_coefficient_buffer(int64_t units) const {
    const int64_t n = int64_t(comps.size());
    if (units * 64 > n * kMaxPixels)
      fail(std::string(progressive ? "progressive" : "multi-scan") +
           " JPEG of " + std::to_string(width) + "x" +
           std::to_string(height) + " pixels: its coefficient buffer of " +
           std::to_string(units * 128) + " bytes is above the limit of " +
           std::to_string(n) + " x " + std::to_string(kMaxPixels) +
           " coefficients (a decompression bomb)");
  }

  // DAC: arithmetic coding's conditioning, per table.
  void read_dac() {
    long length = u16() - 2;
    while (length > 0) {
      const int index = byte(), val = byte();
      length -= 2;
      if (index >= 32) fail("bad DAC segment: table " + std::to_string(index));
      if (index >= 16) {
        dac_k[index - 16] = uint8_t(val);
      } else {
        dac_l[index] = uint8_t(val & 15);
        dac_u[index] = uint8_t(val >> 4);
        if (dac_l[index] > dac_u[index]) fail("bad DAC segment: L above U");
      }
    }
    if (length != 0) fail("bad DAC segment");
  }

  void read_dri() {
    if (u16() != 4) fail("bad DRI segment length");
    restart_interval = u16();
  }

  // APP0 and APP14 (get_interesting_appn: their first 14 bytes examined,
  // the rest skipped); other APPn, COM and DNL skipped (skip_variable).
  void read_appn(int m) {
    long length = u16() - 2;
    if (m != 0xE0 && m != 0xEE) {
      skip(length);
      return;
    }
    uint8_t b[14];
    const int n = int(std::min<long>(std::max<long>(length, 0), 14));
    for (int i = 0; i < n; ++i) b[i] = uint8_t(byte());
    length -= n;
    // examine_app0 / examine_app14: JFIF in an APP0 of 14 bytes at the
    // least, the Adobe transform in an APP14 of 12
    if (m == 0xE0 && n >= 14 && std::memcmp(b, "JFIF\0", 5) == 0)
      jfif = true;
    if (m == 0xEE && n >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = b[11];
    }
    skip(length);
  }

  // The output's planes at this decode's scale (jdmaster.c
  // jpeg_core_output_dimensions): a component's IDCT size starts at the
  // scale and doubles while its sampling leaves room for it, which spares
  // 4:2:0 chroma its upsampling below full size. A lossless frame's planes
  // are its components' samples. Made at the first scan, which tells
  // whether the frame keeps its coefficients to the end.
  void prepare() {
    for (auto& c : comps) {
      if (lossless) {
        c.size = 8;  // for upsample: the factors hmax / h and vmax / v
        c.out_w = c.stride = c.width;
        c.out_h = c.height;
        c.plane.assign(size_t(c.width) * c.height, 0);
        continue;
      }
      int s = scale;
      while (s < 8 && (hmax * scale) % (c.h * s * 2) == 0 &&
             (vmax * scale) % (c.v * s * 2) == 0)
        s *= 2;
      c.size = s;
      c.idct = idct_of_size(s);
      c.out_w = int((int64_t(width) * c.h * s + hmax * 8 - 1) / (hmax * 8));
      c.out_h = int((int64_t(height) * c.v * s + vmax * 8 - 1) / (vmax * 8));
      c.stride = c.bw * s;
      c.plane.assign(size_t(c.stride) * c.bh * s, 128);  // IDCT of zeros
      c.bh_pad = comps.size() > 1 ? mcus_y * c.v : c.bh;
      if (multi_scan) c.coef.assign(size_t(c.bw) * c.bh_pad * 64, 0);
    }
  }

  // Each MCU of a scan in libjpeg's order, mcu(units, n, iMCU row): an
  // interleaved scan's MCUs of its components' h x v blocks, those past
  // a component's edge included (libjpeg codes them but never shows
  // them), a one-component scan's blocks row by row.
  template <class F>
  void each_mcu(const std::vector<Component*>& scan, F&& mcu) {
    Unit u[kMaxBlocksInMcu];
    if (scan.size() == 1) {
      Component& c = *scan[0];
      for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          u[0] = {&c, bx, by};
          mcu(static_cast<const Unit*>(u), 1, by / c.v);
        }
      }
      return;
    }
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        int n = 0;
        for (Component* c : scan)
          for (int by = 0; by < c->v; ++by)
            for (int bx = 0; bx < c->h; ++bx)
              u[n++] = {c, mx * c->h + bx, my * c->v + by};
        mcu(static_cast<const Unit*>(u), n, my);
      }
    }
  }

  int16_t dummy[64] = {};   // the blocks past a component's edge
  int16_t* coefs_of(const Unit& u) {
    Component& c = *u.c;
    return u.bx < c.bw && u.by < c.bh_pad ? c.block(u.bx, u.by) : dummy;
  }

  int dc_add(Component& c, int diff) {
    const int64_t pred = int64_t(c.dc_pred) + diff;
    if (pred > INT32_MAX || pred < INT32_MIN)
      fail("corrupt JPEG data: DC coefficient out of range");
    return c.dc_pred = int(pred);
  }

  // SOS (jdmarker.c get_sos, jdinput.c start_input_pass and the entropy
  // decoders' start_pass), then the scan's data.
  void read_sos() {
    if (!frame) fail("scan before the frame header");
    const int length = u16();
    const int ns = byte();
    if (length != ns * 2 + 6 || ns < 1 || ns > 4) fail("bad SOS segment");
    std::vector<Component*> scan;
    for (int i = 0; i < ns; ++i) {
      const int id = byte(), t = byte();
      // the first component of that id whose index is not below the
      // scan's place for it, as libjpeg matches them (a scan lists its
      // components in the frame's order)
      Component* found = nullptr;
      for (size_t k = scan.size(); k < comps.size() && k < 4 && !found; ++k)
        if (comps[k].id == id) found = &comps[k];
      if (!found || std::find(scan.begin(), scan.end(), found) != scan.end())
        fail("bad SOS segment: component " + std::to_string(id));
      found->td = t >> 4;
      found->ta = t & 15;
      scan.push_back(found);
    }
    int ss = byte(), se = byte(), ah = byte(), al = ah & 15;
    ah >>= 4;
    next_restart_num = 0;
    ++scan_number;
    const bool first = !scanned;
    scanned = true;
    if (first) {
      // jdinput.c initial_setup: one scan of every component, or several
      multi_scan = progressive || ns < int(comps.size());
      if (lossless && scale != 8)
        fail("lossless JPEG (SOF3) is decoded at full size only");
      if (multi_scan && !progressive && !lossless) {
        int64_t units = 0;
        for (const auto& c : comps)
          units += int64_t(c.bw) * (comps.size() > 1 ? mcus_y * c.v : c.bh);
        check_coefficient_buffer(units);
      }
      prepare();
    } else if (!multi_scan) {
      fail("corrupt JPEG data: a second scan where the first coded every "
           "component (libjpeg expects EOI)");
    }
    if (ns > 1) {
      int blocks = 0;
      for (Component* c : scan) blocks += c->h * c->v;
      if (blocks > kMaxBlocksInMcu)
        fail("bad SOS segment: an MCU of " + std::to_string(blocks) +
             " blocks (libjpeg reads 10 at the most)");
    }
    if (lossless) {
      // jdlossls.c: Ss the predictor, Se and Ah unused, Al the point
      // transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
        fail("bad lossless scan: Ss=" + std::to_string(ss) + " Se=" +
             std::to_string(se) + " Ah=" + std::to_string(ah) + " Al=" +
             std::to_string(al));
    } else if (!progressive) {
      ss = 0;  // a sequential scan's Ss, Se, Ah/Al are 0, 63, 0 (libjpeg
      se = 63; // only warns of others)
      ah = al = 0;
    } else {
      // jdphuff.c / jdarith.c start_pass: a DC scan codes Ss = Se = 0, an
      // AC scan one component's band; a refinement codes the next bit.
      bool bad = ss == 0 ? se != 0 : ss > se || se > 63 || ns != 1;
      if (bad || (ah && al != ah - 1) || al > 13)
        fail("bad progressive scan: Ss=" + std::to_string(ss) + " Se=" +
             std::to_string(se) + " Ah=" + std::to_string(ah) + " Al=" +
             std::to_string(al));
      // A band or bit decoded again, or out of order, is decoded all the
      // same (libjpeg warns of a bogus progression); the bits before this
      // scan are kept for block smoothing.
      for (Component* c : scan) {
        for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
          c->prev_bits[k] = scan_number > 1 ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = int8_t(al);
      }
    }
    for (Component* c : scan) {
      if (!lossless && !c->latched) {
        if (!qt_present[c->tq]) fail("missing quantization table");
        std::memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->latched = true;
      }
      if (lossless) c->coef_bits[0] = 0;
      if (!arithmetic) {
        // A scan's tables are checked as it derives them (a table it does
        // not read is not looked up). Where a sequential frame has none,
        // libjpeg-turbo's standard tables 0 and 1 stand in (Motion-JPEG
        // frames; jdhuff.c alone: its progressive and lossless decoders
        // refuse a missing table).
        const int max_dc = lossless ? 16 : 15;
        for (int cls = 0; cls < 2; ++cls) {
          if (cls == 0 && progressive && !(ss == 0 && ah == 0)) continue;
          if (cls == 1 && (lossless || (progressive && ss == 0))) continue;
          const int t = cls ? c->ta : c->td;
          if (t > 3)
            fail("bad SOS segment: Huffman table " + std::to_string(t));
          DecHuff& h = (cls ? ac : dc)[t];
          if (!h.present) {
            if (t > 1 || progressive || lossless)
              fail("bad SOS segment: Huffman table " + std::to_string(t) +
                   " is not defined");
            const StdHuff& sh = kStdHuff[cls][t];
            h.define(sh.bits, sh.vals, sh.nvals);
          }
          h.derive(cls ? -1 : max_dc);
        }
      } else {
        if (!progressive || (ss == 0 && ah == 0))
          std::memset(dc_stats[c->td], 0, sizeof(dc_stats[0]));
        if (!progressive || ss)
          std::memset(ac_stats[c->ta], 0, sizeof(ac_stats[0]));
      }
      c->dc_pred = 0;
      c->dc_context = 0;
    }
    get_buffer = 0;
    bits_left = 0;
    insufficient = false;
    ar_c = ar_a = 0;
    ar_ct = -16;
    if (lossless)
      scan_lossless(scan, ss, al);
    else if (arithmetic)
      scan_arithmetic(scan, ss, se, ah, al);
    else if (progressive)
      scan_progressive(scan, ss, se, ah, al);
    else
      scan_sequential(scan);
    if (!multi_scan) rows_done = true;
  }

  // A sequential Huffman-coded scan (jdhuff.c decode_mcu): a one-scan
  // frame's blocks decoded and shown MCU by MCU, a buffered one's into
  // its coefficients. Once the data has run out (a marker met), the
  // blocks to the next restart get no coefficients.
  void scan_sequential(const std::vector<Component*>& scan) {
    int restarts_to_go = restart_interval;
    int16_t temp[kMaxBlocksInMcu][64];
    int16_t* b[kMaxBlocksInMcu];
    each_mcu(scan, [&](const Unit* u, int n, int imcu) {
      for (int i = 0; i < n; ++i) {
        if (multi_scan) {
          b[i] = coefs_of(u[i]);
        } else {
          std::memset(temp[i], 0, sizeof(temp[i]));
          b[i] = temp[i];
        }
      }
      if (!insufficient) last_good_imcu = imcu;
      if (restart_interval && restarts_to_go == 0) {
        huff_restart();
        for (Component* c : scan) c->dc_pred = 0;
        restarts_to_go = restart_interval;
      }
      if (!insufficient) huff_mcu(scan, u, n, b);
      if (restart_interval) --restarts_to_go;
      if (!multi_scan)
        for (int i = 0; i < n; ++i)
          if (u[i].bx < u[i].c->bw && u[i].by < u[i].c->bh)
            u[i].c->emit(u[i].bx, u[i].by, b[i]);
    });
  }

  // One MCU by decode_mcu_fast where libjpeg takes it (no restart
  // interval, no marker unread, 512 bytes a block left of what the source
  // was handed), else by decode_mcu_slow; the fast one gives way to the
  // slow one, from the MCU's start, at a marker. Only PIL's source tells
  // them apart: where the data ends, by how far each has read ahead.
  void huff_mcu(const std::vector<Component*>& scan, const Unit* u, int n,
                int16_t* const* b) {
    if (end == End::kSuspend && restart_interval == 0 && unread_marker == 0 &&
        limit - pos >= size_t(512) * n) {
      const uint64_t buf = get_buffer;
      const int left = bits_left;
      const size_t at = pos;
      int pred[4];
      for (size_t k = 0; k < scan.size(); ++k) pred[k] = scan[k]->dc_pred;
      if (huff_mcu_fast(u, n, b)) return;
      get_buffer = buf;
      bits_left = left;
      pos = at;
      for (size_t k = 0; k < scan.size(); ++k) scan[k]->dc_pred = pred[k];
    }
    huff_mcu_slow(u, n, b);
  }

  void huff_mcu_slow(const Unit* u, int n, int16_t* const* b) {
    for (int i = 0; i < n; ++i) {
      Component& c = *u[i].c;
      int s = huff_decode(dc[c.td]);
      if (s) {
        check_bits(s);
        s = extend(get_bits(s), s);
      }
      b[i][0] = int16_t(dc_add(c, s));  // libjpeg's JCOEF is 16 bits
      const DecHuff& h = ac[c.ta];
      for (int k = 1; k < 64; ++k) {
        s = huff_decode(h);
        const int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          check_bits(s);
          b[i][kNatural[k]] = int16_t(extend(get_bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  bool huff_mcu_fast(const Unit* u, int n, int16_t* const* b) {
    for (int i = 0; i < n; ++i) {
      Component& c = *u[i].c;
      int s = huff_decode_fast(dc[c.td]);
      if (s) {
        fill_fast();
        s = extend(get_bits(s), s);
      }
      b[i][0] = int16_t(dc_add(c, s));
      const DecHuff& h = ac[c.ta];
      for (int k = 1; k < 64; ++k) {
        s = huff_decode_fast(h);
        const int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          fill_fast();
          b[i][kNatural[k]] = int16_t(extend(get_bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    if (unread_marker == 0) return true;
    unread_marker = 0;
    return false;
  }

  // A progressive Huffman-coded scan (jdphuff.c decode_mcu_DC_first,
  // _DC_refine, _AC_first, _AC_refine) into the coefficient buffers. Once
  // the data has run out, the blocks to the next restart keep what the
  // earlier scans gave them.
  void scan_progressive(const std::vector<Component*>& scan, int ss, int se,
                        int ah, int al) {
    int restarts_to_go = restart_interval;
    int eobrun = 0;
    const int p1 = 1 << al, m1 = -p1;  // 1 and -1 in the bit coded
    // A correction bit for a coefficient already nonzero, where its
    // magnitude takes the bit coded.
    auto refine = [&](int16_t& coef) {
      check_bits(1);
      if (get_bits(1) && (coef & p1) == 0)
        coef = int16_t(coef + (coef >= 0 ? p1 : m1));
    };
    each_mcu(scan, [&](const Unit* u, int n, int imcu) {
      if (!insufficient) last_good_imcu = imcu;
      if (restart_interval && restarts_to_go == 0) {
        huff_restart();
        for (Component* c : scan) c->dc_pred = 0;
        eobrun = 0;
        restarts_to_go = restart_interval;
      }
      if (restart_interval) --restarts_to_go;
      if (insufficient) return;
      if (se == 0 && ah == 0) {
        for (int i = 0; i < n; ++i) {
          Component& c = *u[i].c;
          int s = huff_decode(dc[c.td]);
          if (s) {
            check_bits(s);
            s = extend(get_bits(s), s);
          }
          coefs_of(u[i])[0] = int16_t(unsigned(dc_add(c, s)) << al);
        }
      } else if (se == 0) {
        for (int i = 0; i < n; ++i) {
          check_bits(1);
          int16_t* b = coefs_of(u[i]);
          if (get_bits(1)) b[0] = int16_t(b[0] | p1);
        }
      } else if (ah == 0) {
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        int16_t* b = coefs_of(u[0]);
        const DecHuff& h = ac[u[0].c->ta];
        for (int k = ss; k <= se; ++k) {
          int s = huff_decode(h);
          int r = s >> 4;
          s &= 15;
          if (s) {
            k += r;
            check_bits(s);
            b[kNatural[k]] = int16_t(unsigned(extend(get_bits(s), s)) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) {
              check_bits(r);
              eobrun += get_bits(r);
            }
            --eobrun;
            break;
          }
        }
      } else {
        int16_t* b = coefs_of(u[0]);
        const DecHuff& h = ac[u[0].c->ta];
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            int s = huff_decode(h);
            int r = s >> 4;
            s &= 15;
            if (s) {
              check_bits(1);
              s = get_bits(1) ? p1 : m1;  // the new coefficient's sign
            } else if (r != 15) {
              eobrun = 1 << r;
              if (r) {
                check_bits(r);
                eobrun += get_bits(r);
              }
              break;
            }
            // skip r zero coefficients, refining the nonzero ones passed
            do {
              int16_t& coef = b[kNatural[k]];
              if (coef != 0)
                refine(coef);
              else if (--r < 0)
                break;
              ++k;
            } while (k <= se);
            if (s) b[kNatural[k]] = int16_t(s);
          }
        }
        if (eobrun > 0) {
          for (; k <= se; ++k)
            if (b[kNatural[k]] != 0) refine(b[kNatural[k]]);
          --eobrun;
        }
      }
    });
  }

  // An arithmetic-coded DC difference (jdarith.c, T.81 F.1.4.4.1) added to
  // the component's prediction, which libjpeg keeps in 16 bits, unsigned;
  // false for a magnitude past 15 bits.
  bool arith_dc(Component& c, int* value) {
    uint8_t* stats = dc_stats[c.td];
    uint8_t* st = stats + c.dc_context;
    if (arith_decode(st) == 0) {
      c.dc_context = 0;
    } else {
      const int sign = arith_decode(st + 1);
      st += 2 + sign;
      int m = arith_decode(st);
      if (m != 0) {
        st = stats + 20;
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
      if (m < int((1L << dac_l[c.td]) >> 1))
        c.dc_context = 0;
      else if (m > int((1L << dac_u[c.td]) >> 1))
        c.dc_context = 12 + sign * 4;
      else
        c.dc_context = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      c.dc_pred = (c.dc_pred + v) & 0xFFFF;
    }
    *value = c.dc_pred;
    return true;
  }

  // Arithmetic-coded AC coefficients ss..se of a block (T.81 F.1.4.4.2),
  // each shifted up by al; false at a coding error (a run or a magnitude
  // past its range), the coefficients decoded before it kept.
  bool arith_ac(Component& c, int16_t* coef, int ss, int se, int al) {
    uint8_t* stats = ac_stats[c.ta];
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;
      }
      uint8_t fixed = 113;
      const int sign = arith_decode(&fixed);
      st += 2;
      int m = arith_decode(st);
      if (m != 0 && arith_decode(st)) {
        m <<= 1;
        st = stats + (k <= dac_k[c.ta] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      coef[kNatural[k]] = int16_t(unsigned(v) << al);
    }
    return true;
  }

  // An arithmetic-coded AC refinement (jdarith.c decode_mcu_AC_refine).
  bool arith_ac_refine(Component& c, int16_t* b, int ss, int se, int al) {
    uint8_t* stats = ac_stats[c.ta];
    const int p1 = 1 << al, m1 = -p1;
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (b[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t& coef = b[kNatural[k]];
        if (coef) {
          if (arith_decode(st + 2)) coef = int16_t(coef + (coef < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {
          uint8_t fixed = 113;
          coef = int16_t(arith_decode(&fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }

  // An arithmetic-coded scan (jdarith.c decode_mcu and, progressive,
  // decode_mcu_DC_first, _DC_refine, _AC_first, _AC_refine): libjpeg
  // resets the statistics of the scan's tables at each restart. A coding
  // error, of which libjpeg only warns, stops the MCU where it is met; the
  // MCUs after it to the next restart get nothing (CT -1).
  void scan_arithmetic(const std::vector<Component*>& scan, int ss, int se,
                       int ah, int al) {
    int restarts_to_go = restart_interval;
    auto restart = [&] {
      read_restart_marker();
      for (Component* c : scan) {
        if (!progressive || (ss == 0 && ah == 0)) {
          std::memset(dc_stats[c->td], 0, sizeof(dc_stats[0]));
          c->dc_pred = 0;
          c->dc_context = 0;
        }
        if (!progressive || ss)
          std::memset(ac_stats[c->ta], 0, sizeof(ac_stats[0]));
      }
      ar_c = ar_a = 0;
      ar_ct = -16;
      restarts_to_go = restart_interval;
    };
    int16_t temp[kMaxBlocksInMcu][64];
    each_mcu(scan, [&](const Unit* u, int n, int imcu) {
      if (!insufficient) last_good_imcu = imcu;
      int16_t* b[kMaxBlocksInMcu];
      for (int i = 0; i < n; ++i) {
        if (multi_scan) {
          b[i] = coefs_of(u[i]);
        } else {
          std::memset(temp[i], 0, sizeof(temp[i]));
          b[i] = temp[i];
        }
      }
      if (restart_interval) {
        if (restarts_to_go == 0) restart();
        --restarts_to_go;
      }
      auto error = [&] { ar_ct = -1; };
      if (ar_ct != -1) {
        if (!progressive) {
          for (int i = 0; i < n; ++i) {
            int v = 0;
            if (!arith_dc(*u[i].c, &v)) {
              error();
              break;
            }
            b[i][0] = int16_t(v);
            if (!arith_ac(*u[i].c, b[i], 1, 63, 0)) {
              error();
              break;
            }
          }
        } else if (se == 0 && ah == 0) {
          for (int i = 0; i < n; ++i) {
            int v = 0;
            if (!arith_dc(*u[i].c, &v)) {
              error();
              break;
            }
            b[i][0] = int16_t(unsigned(v) << al);
          }
        } else if (se == 0) {
          for (int i = 0; i < n; ++i) {
            uint8_t fixed = 113;
            if (arith_decode(&fixed)) b[i][0] = int16_t(b[i][0] | (1 << al));
          }
        } else if (ah == 0) {
          if (!arith_ac(*u[0].c, b[0], ss, se, al)) error();
        } else {
          if (!arith_ac_refine(*u[0].c, b[0], ss, se, al)) error();
        }
      }
      if (!multi_scan)
        for (int i = 0; i < n; ++i)
          if (u[i].bx < u[i].c->bw && u[i].by < u[i].c->bh)
            u[i].c->emit(u[i].bx, u[i].by, b[i]);
    });
  }

  // A lossless scan (jddiffct.c, jdlhuff.c, jdpred.c): the sample
  // differences of an iMCU row (a one-component scan's v MCU rows of one
  // sample, an interleaved scan's one row of MCUs of h x v samples), then
  // each row undifferenced by the predictor psv and scaled by the point
  // transform pt. A row after the scan's start or a restart predicts from
  // its left neighbour alone, its first sample from 2^(7 - pt); every
  // other row's first sample from the sample above it. Values are kept in
  // 16 bits and the output is their low 8 bits after the shift, as libjpeg
  // keeps them. Once the data has run out, an MCU row's differences are
  // zeros and the iMCU row starts the prediction again (mid grey).
  void scan_lossless(const std::vector<Component*>& scan, int psv, int pt) {
    const bool one = scan.size() == 1;
    const int per_row = one ? scan[0]->width : mcus_x;
    if (restart_interval % per_row)
      fail("lossless JPEG with a restart interval of " +
           std::to_string(restart_interval) + " MCUs, not whole rows of " +
           std::to_string(per_row) + ", is not supported");
    struct Rows {
      std::vector<int32_t> diff, prev, cur;
      int cols = 0;
      bool first = true;
    };
    std::vector<Rows> rows(scan.size());
    for (size_t i = 0; i < scan.size(); ++i) {
      const Component& c = *scan[i];
      rows[i].cols = one ? c.width : mcus_x * c.h;
      rows[i].diff.assign(size_t(rows[i].cols) * c.v, 0);
      rows[i].prev.assign(c.width, 0);
      rows[i].cur.assign(c.width, 0);
    }
    auto diff = [&](Component& c) {
      int s = huff_decode(dc[c.td]);
      if (s == 16) return 32768;
      if (!s) return 0;
      check_bits(s);
      return extend(get_bits(s), s);
    };
    const int initial = 1 << (7 - pt);
    int rows_to_go = restart_interval / per_row;
    for (int i = 0; i < mcus_y; ++i) {
      const bool last = i == mcus_y - 1;
      const int mcu_rows =
          !one ? 1 : last && scan[0]->height % scan[0]->v
                         ? scan[0]->height % scan[0]->v : scan[0]->v;
      for (int y = 0; y < mcu_rows; ++y) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            huff_restart();
            for (auto& r : rows) r.first = true;
            rows_to_go = restart_interval / per_row;
          }
          --rows_to_go;
        }
        if (insufficient) {   // decode_mcus: zeros, the predictors reset
          for (auto& r : rows) {
            r.first = true;
            const size_t from = one ? size_t(y) * r.cols : 0;
            std::fill(r.diff.begin() + from,
                      one ? r.diff.begin() + from + r.cols : r.diff.end(), 0);
          }
          continue;
        }
        for (int mx = 0; mx < per_row; ++mx) {
          if (one) {
            rows[0].diff[size_t(y) * rows[0].cols + mx] = diff(*scan[0]);
            continue;
          }
          for (size_t j = 0; j < scan.size(); ++j) {
            Component& c = *scan[j];
            for (int by = 0; by < c.v; ++by)
              for (int bx = 0; bx < c.h; ++bx)
                rows[j].diff[size_t(by) * rows[j].cols + mx * c.h + bx] =
                    diff(c);
          }
        }
      }
      for (size_t j = 0; j < scan.size(); ++j) {
        Component& c = *scan[j];
        Rows& r = rows[j];
        const int n = last && c.height % c.v ? c.height % c.v : c.v;
        for (int y = 0; y < n; ++y) {
          const int32_t* d = r.diff.data() + size_t(y) * r.cols;
          int32_t* out = r.cur.data();
          const int32_t* up = r.prev.data();
          int ra = (d[0] + (r.first ? initial : up[0])) & 0xFFFF;
          out[0] = ra;
          for (int x = 1; x < c.width; ++x) {
            const int rb = up[x], rc = up[x - 1];
            const int pred = r.first ? ra
                             : psv == 1 ? ra
                             : psv == 2 ? rb
                             : psv == 3 ? rc
                             : psv == 4 ? ra + rb - rc
                             : psv == 5 ? ra + ((rb - rc) >> 1)
                             : psv == 6 ? rb + ((ra - rc) >> 1)
                                        : (ra + rb) >> 1;
            ra = (d[x] + pred) & 0xFFFF;
            out[x] = ra;
          }
          r.first = false;
          uint8_t* o = c.plane.data() + size_t(i * c.v + y) * c.stride;
          for (int x = 0; x < c.width; ++x) o[x] = uint8_t(out[x] << pt);
          std::swap(r.prev, r.cur);
        }
      }
    }
  }

  // Whether libjpeg would smooth the blocks of this progressive frame
  // (jdcoefct.c smoothing_ok, with every scan read): every component's DC
  // known and its first quantizers nonzero, and some component's
  // coefficients 1-9 short of their last bit.
  bool smoothing_applies() const {
    bool useful = false;
    for (const auto& c : comps) {
      for (int k = 0; k < kSmoothCoefs; ++k)
        if (c.q[kNatural[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < kSmoothCoefs; ++k)
        useful |= c.coef_bits[k] != 0;
    }
    return useful;
  }

  // libjpeg-turbo's block smoothing of a component (jdcoefct.c
  // decompress_smooth_data, 2.1 and later), then its inverse DCTs: each
  // block's coefficients 1-9 that are still zero and short of their last
  // bit are estimated from the DC values of the 5 x 5 blocks around it,
  // clamped below the bits not yet coded; where no AC coefficient was
  // coded at all, a Gaussian-like kernel estimates them and the DC too.
  // Which blocks stand in for the neighbours missing at the frame's edges
  // is where the versions differ (`turbo3`):
  //   * libjpeg-turbo 2.1 (the JAX loader's): rows by its iMCU-row buffer,
  //     so that the top two and bottom two iMCU rows of a component of
  //     vertical sampling v > 1 repeat the nearer row where the buffer holds
  //     the farther one; columns by its sliding registers (a component two
  //     blocks wide repeats its first column on the right);
  //   * libjpeg-turbo 3 (PIL's): rows and columns clamped to the frame, but
  //     for a row two below reaching into the rows an interleaved scan
  //     codes past the component's edge (kept in the coefficient buffer,
  //     bh_pad), and for the second iMCU row where it is the last and one
  //     block row high, whose row two above repeats the row above.
  void emit_smoothed(Component& c) {
    // smoothing_ok's latches: the bits after every scan and, for the iMCU
    // rows past the last that a scan reached with data, those before the
    // component's latest scan (none at all where there was one scan)
    int8_t now[kSmoothCoefs], before[kSmoothCoefs];
    for (int k = 0; k < kSmoothCoefs; ++k) {
      now[k] = c.coef_bits[k];
      before[k] = scan_number > 1 ? c.prev_bits[k] : -1;
    }
    const int64_t q00 = c.q[0], q01 = c.q[1], q10 = c.q[8], q20 = c.q[16],
                  q11 = c.q[9], q02 = c.q[2], q03 = c.q[3], q12 = c.q[10],
                  q21 = c.q[17], q30 = c.q[24];
    // pred = round(num / (q << 8)) away from zero, below 2^al where al > 0
    auto estimate = [](int64_t num, int64_t q, int al) {
      const bool neg = num < 0;
      int pred = int(((q << 7) + (neg ? -num : num)) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      return int16_t(neg ? -pred : pred);
    };
    const int last_imcu = mcus_y - 1, v = c.v, last_col = c.bw - 1;
    int16_t w[64];
    for (int r = 0; r < c.bh; ++r) {
      const int i = r / v, br = r % v;
      const int8_t* bits = i > last_good_imcu ? before : now;
      bool change_dc = true;
      for (int k = 1; k < kSmoothCoefs; ++k) change_dc &= bits[k] == -1;
      const int rows = i < last_imcu ? v : c.bh - last_imcu * v;
      int prev, prev2, next, next2;
      if (turbo3) {
        prev = r > 0 ? r - 1 : r;
        prev2 = r > 1 && !(i == 1 && i == last_imcu && rows == 1) ? r - 2
                                                                  : prev;
        next = r + 1 < c.bh ? r + 1 : r;
        next2 = r + 2 < c.bh_pad ? r + 2 : next;
      } else {
        prev = br > 0 || i > 0 ? r - 1 : r;
        prev2 = br > 1 || i > 1 ? r - 2 : prev;
        next = br < rows - 1 || i < last_imcu ? r + 1 : r;
        next2 = br < rows - 2 || i + 1 < last_imcu ? r + 2 : next;
      }
      const int16_t* row[5] = {c.block(0, prev2), c.block(0, prev),
                               c.block(0, r), c.block(0, next),
                               c.block(0, next2)};
      // D[y][x]: libjpeg's DC01..DC25, x the column from two left to two
      // right of the block
      int D[5][5];
      for (int y = 0; y < 5; ++y)
        for (int x = 0; x < 5; ++x) D[y][x] = row[y][0];
      for (int b = 0; b < c.bw; ++b) {
        if (turbo3) {
          for (int y = 0; y < 5; ++y)
            for (int x = 0; x < 5; ++x)
              D[y][x] = row[y][64 * std::min(std::max(b + x - 2, 0),
                                             last_col)];
        } else {
          if (b == 0 && b < last_col)
            for (int y = 0; y < 5; ++y) D[y][3] = row[y][64 * 1];
          if (b + 1 < last_col)
            for (int y = 0; y < 5; ++y) D[y][4] = row[y][64 * (b + 2)];
        }
        std::memcpy(w, c.block(b, r), sizeof(w));
        auto dc = [&](int n) { return int64_t(D[(n - 1) / 5][(n - 1) % 5]); };
        int al;
        if ((al = bits[1]) != 0 && w[1] == 0) {
          const int64_t num = q00 * (change_dc
              ? -dc(1) - dc(2) + dc(4) + dc(5) - 3 * dc(6) + 13 * dc(7) -
                13 * dc(9) + 3 * dc(10) - 3 * dc(11) + 38 * dc(12) -
                38 * dc(14) + 3 * dc(15) - 3 * dc(16) + 13 * dc(17) -
                13 * dc(19) + 3 * dc(20) - dc(21) - dc(22) + dc(24) + dc(25)
              : -7 * dc(11) + 50 * dc(12) - 50 * dc(14) + 7 * dc(15));
          w[1] = estimate(num, q01, al);
        }
        if ((al = bits[2]) != 0 && w[8] == 0) {
          const int64_t num = q00 * (change_dc
              ? -dc(1) - 3 * dc(2) - 3 * dc(3) - 3 * dc(4) - dc(5) - dc(6) +
                13 * dc(7) + 38 * dc(8) + 13 * dc(9) - dc(10) + dc(16) -
                13 * dc(17) - 38 * dc(18) - 13 * dc(19) + dc(20) + dc(21) +
                3 * dc(22) + 3 * dc(23) + 3 * dc(24) + dc(25)
              : -7 * dc(3) + 50 * dc(8) - 50 * dc(18) + 7 * dc(23));
          w[8] = estimate(num, q10, al);
        }
        if ((al = bits[3]) != 0 && w[16] == 0) {
          const int64_t num = q00 * (change_dc
              ? dc(3) + 2 * dc(7) + 7 * dc(8) + 2 * dc(9) - 5 * dc(12) -
                14 * dc(13) - 5 * dc(14) + 2 * dc(17) + 7 * dc(18) +
                2 * dc(19) + dc(23)
              : -dc(3) + 13 * dc(8) - 24 * dc(13) + 13 * dc(18) - dc(23));
          w[16] = estimate(num, q20, al);
        }
        if ((al = bits[4]) != 0 && w[9] == 0) {
          const int64_t num = q00 * (change_dc
              ? -dc(1) + dc(5) + 9 * dc(7) - 9 * dc(9) - 9 * dc(17) +
                9 * dc(19) + dc(21) - dc(25)
              : dc(10) + dc(16) - 10 * dc(17) + 10 * dc(19) - dc(2) -
                dc(20) + dc(22) - dc(24) + dc(4) - dc(6) + 10 * dc(7) -
                10 * dc(9));
          w[9] = estimate(num, q11, al);
        }
        if ((al = bits[5]) != 0 && w[2] == 0) {
          const int64_t num = q00 * (change_dc
              ? 2 * dc(7) - 5 * dc(8) + 2 * dc(9) + dc(11) + 7 * dc(12) -
                14 * dc(13) + 7 * dc(14) + dc(15) + 2 * dc(17) -
                5 * dc(18) + 2 * dc(19)
              : -dc(11) + 13 * dc(12) - 24 * dc(13) + 13 * dc(14) - dc(15));
          w[2] = estimate(num, q02, al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && w[3] == 0)
            w[3] = estimate(q00 * (dc(7) - dc(9) + 2 * dc(12) - 2 * dc(14) +
                                   dc(17) - dc(19)), q03, al);
          if ((al = bits[7]) != 0 && w[10] == 0)
            w[10] = estimate(q00 * (dc(7) - 3 * dc(8) + dc(9) - dc(17) +
                                    3 * dc(18) - dc(19)), q12, al);
          if ((al = bits[8]) != 0 && w[17] == 0)
            w[17] = estimate(q00 * (dc(7) - dc(9) - 3 * dc(12) +
                                    3 * dc(14) + dc(17) - dc(19)), q21, al);
          if ((al = bits[9]) != 0 && w[24] == 0)
            w[24] = estimate(q00 * (dc(7) + 2 * dc(8) + dc(9) - dc(17) -
                                    2 * dc(18) - dc(19)), q30, al);
          const int64_t num = q00 *
              (-2 * dc(1) - 6 * dc(2) - 8 * dc(3) - 6 * dc(4) - 2 * dc(5) -
               6 * dc(6) + 6 * dc(7) + 42 * dc(8) + 6 * dc(9) - 6 * dc(10) -
               8 * dc(11) + 42 * dc(12) + 152 * dc(13) + 42 * dc(14) -
               8 * dc(15) - 6 * dc(16) + 6 * dc(17) + 42 * dc(18) +
               6 * dc(19) - 6 * dc(20) - 2 * dc(21) - 6 * dc(22) -
               8 * dc(23) - 6 * dc(24) - 2 * dc(25));
          w[0] = estimate(num, q00, 0);
        }
        c.emit(b, r, w);
        for (int y = 0; y < 5; ++y)
          for (int x = 0; x < 4; ++x) D[y][x] = D[y][x + 1];
      }
    }
  }

  // A component's plane upsampled to the output's size (jdsample.c): rows
  // and columns past the plane's own size are its last ones repeated. The
  // triangular filters need an IDCT above 1 x 1 (jinit_upsampler), which a
  // lossless frame does not have.
  std::vector<uint8_t> upsample(const Component& c, int ow, int oh) const {
    const int hf = hmax * scale / (c.h * c.size);
    const int vf = vmax * scale / (c.v * c.size);
    const int cw = c.out_w, ch = c.out_h;
    const bool fancy = scale > 1 && !lossless;
    std::vector<uint8_t> out(size_t(ow) * oh);
    std::vector<int> sum(size_t(cw) + 2);  // with a repeated edge each side
    auto row = [&](int r) {
      return c.plane.data() + size_t(std::min(std::max(r, 0), ch - 1)) *
                                  c.stride;
    };
    const bool fancy_h = fancy && hf == 2 && cw > 2;
    for (int y = 0; y < oh; ++y) {
      uint8_t* o = out.data() + size_t(y) * ow;
      const int sy = y / vf, dy = y % vf;
      const uint8_t* here = row(sy);
      if (hf == 1 && vf == 1) {
        std::memcpy(o, here, ow);
        continue;
      }
      if (vf == 2 && (fancy_h || (fancy && hf == 1))) {
        // triangular in y: 3/4 this row, 1/4 the nearer neighbour
        const uint8_t* near = row(dy ? sy + 1 : sy - 1);
        for (int i = 0; i < cw; ++i) sum[i + 1] = 3 * here[i] + near[i];
        if (hf == 1) {  // h1v2
          const int bias = dy ? 2 : 1;
          for (int x = 0; x < ow; ++x)
            o[x] = uint8_t((sum[x + 1] + bias) >> 2);
          continue;
        }
      } else if (fancy_h && vf == 1) {
        for (int i = 0; i < cw; ++i) sum[i + 1] = here[i];
      } else {  // box replication
        for (int x = 0; x < ow; ++x) o[x] = here[x / hf];
        continue;
      }
      sum[0] = sum[1];
      sum[cw + 1] = sum[cw];
      // triangular in x: h2v2 in 4 x 16ths (+8, +7), h2v1 in 4ths (+1, +2)
      const int shift = vf == 2 ? 4 : 2;
      const int b0 = vf == 2 ? 8 : 1, b1 = vf == 2 ? 7 : 2;
      for (int x = 0; x < ow; ++x) {
        const int i = (x >> 1) + 1;
        o[x] = uint8_t(x & 1 ? (3 * sum[i] + sum[i + 1] + b1) >> shift
                             : (3 * sum[i] + sum[i - 1] + b0) >> shift);
      }
    }
    return out;
  }

  // jdmarker.c read_markers and jdinput.c consume_markers over the whole
  // stream: every marker to EOI, each scan's data read as it comes. A
  // header-only read (out == nullptr) stops at the frame header.
  void read_stream(bool header_only) {
    // first_marker
    if (byte() != 0xFF || byte() != 0xD8) fail("not a JPEG (no SOI marker)");
    for (;;) {
      if (unread_marker == 0) next_marker();
      const int m = unread_marker;
      unread_marker = 0;
      if (m == 0xD9) return;  // EOI
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 ||
          m == 0xCA) {
        read_sof(m);
        if (header_only) return;
      } else if (m == 0xCB) {
        fail("arithmetic-coded lossless JPEG (SOF11) is not supported");
      } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD ||
                 m == 0xCE || m == 0xCF) {
        fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
             ") is not supported");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xCC) {
        read_dac();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        read_dri();
      } else if (m == 0xDA) {
        const bool first = !scanned;
        read_sos();
        if (stop_after_scan && first && !multi_scan) return;
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        continue;  // a stray restart marker or TEM: no parameters
      } else if (m == 0xD8) {
        fail("a second SOI marker");
      } else if (!(m >= 0xE0 && m <= 0xEF) && m != 0xFE && m != 0xDC) {
        // DHP, EXP, JPGn and RESn are fatal
        char hex[8];
        std::snprintf(hex, sizeof(hex), "%02X", m);
        fail(std::string("unsupported marker type 0x") + hex);
      } else {
        read_appn(m);  // APPn, COM and DNL (ignored)
      }
    }
  }

  // With out == nullptr: read up to the frame header and stop (the frame's
  // size and kind are then known). Otherwise decode the whole file into
  // out, which holds want_w x want_h x 3 bytes: the frame at scale / 8 of
  // its size.
  void run(uint8_t* out, int want_w, int want_h) {
    limit = end == End::kFakeEoi ? size : std::min(size, kPilBlock);
    header_only = out == nullptr;
    try {
      read_stream(header_only);
    } catch (const Suspended&) {
      // PIL: libjpeg suspended for data there is none of; its rows stand
      // where every one was out (jpeg_finish_decompress's suspension is
      // not an error to Pillow)
      if (!out || !rows_done)
        fail("truncated JPEG: its data ends before every row is decoded "
             "(PIL: image file is truncated)");
    }
    if (!out) {
      if (!frame) fail("JPEG without a frame header");
      return;
    }
    if (!frame) fail("JPEG without a frame header");
    // jdapimin.c jpeg_read_header: an image needs a scan
    if (!scanned) fail("JPEG without a scan (missing SOS marker)");
    // A component that no scan coded is mid grey (its blocks all zero, as
    // libjpeg leaves them); a lossless frame's has no value to show.
    for (auto& c : comps)
      if (c.coef_bits[0] < 0 && lossless)
        fail("truncated JPEG: a component has no scan");
    const int ow = int((int64_t(width) * scale + 7) / 8);
    const int oh = int((int64_t(height) * scale + 7) / 8);
    if (ow != want_w || oh != want_h)
      fail("JPEG frame of another size than its header gave");
    if (multi_scan && !lossless) {
      const bool smooth = progressive && smoothing_applies();
      for (auto& c : comps) {
        if (smooth) {
          emit_smoothed(c);
          continue;
        }
        for (int by = 0; by < c.bh; ++by)
          for (int bx = 0; bx < c.bw; ++bx) c.emit(bx, by, c.block(bx, by));
      }
    }
    uint8_t* o = out;
    if (colour == kColourRaw) {
      const size_t nc = comps.size();
      for (size_t k = 0; k < nc; ++k) {
        const std::vector<uint8_t> g = upsample(comps[k], ow, oh);
        for (size_t i = 0; i < g.size(); ++i) o[nc * i + k] = g[i];
      }
      return;
    }
    if (colour == kColourYcc && (comps.size() != 3 || lossless))
      fail("JPEG: YCbCr to RGB asked of a frame of " +
           std::to_string(comps.size()) + " components");
    if (comps.size() == 1) {
      std::vector<uint8_t> g = upsample(comps[0], ow, oh);
      for (size_t i = 0; i < g.size(); ++i)
        o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = g[i];
      return;
    }
    std::vector<std::vector<uint8_t>> p;
    for (const auto& c : comps) p.push_back(upsample(c, ow, oh));
    const size_t n = p[0].size();
    // jdcolor.c build_ycc_rgb_table: YCbCr -> RGB in fixed point
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
    if (comps.size() == 4) {
      // jdapimin.c default_decompress_parms: CMYK unless an Adobe marker's
      // transform is not 0 (YCCK, jdcolor.c ycck_cmyk_convert); PIL then
      // inverts the samples ("CMYK;I") and applies cmyk2rgb.
      const bool ycck = adobe && adobe_transform != 0;
      if (ycck && lossless) fail(kLosslessColour);
      for (size_t i = 0; i < n; ++i) {
        int cmy[3] = {p[0][i], p[1][i], p[2][i]};
        if (ycck) {
          const int y = cmy[0], cb = cmy[1], cr = cmy[2];
          cmy[0] = limit(255 - (y + cr_r[cr]));
          cmy[1] = limit(255 - (y + int((cb_g[cb] + cr_g[cr]) >> 16)));
          cmy[2] = limit(255 - (y + cb_b[cb]));
        }
        const int nk = p[3][i];  // 255 - the inverted K
        for (int ch = 0; ch < 3; ++ch) {
          const int t = (255 - cmy[ch]) * nk + 128;  // Pillow's MULDIV255
          o[3 * i + ch] = limit(nk - (((t >> 8) + t) >> 8));
        }
      }
      return;
    }
    // jdapimin.c default_decompress_parms: JFIF implies YCbCr; else the
    // Adobe transform; else component ids 'R', 'G', 'B' mean RGB (and in a
    // lossless frame any ids do).
    const bool ids_rgb = comps[0].id == 'R' && comps[1].id == 'G' &&
                         comps[2].id == 'B';
    const bool is_rgb = colour == kColourPil && !jfif &&
                        (adobe ? adobe_transform == 0 : ids_rgb || lossless);
    if (!is_rgb && lossless) fail(kLosslessColour);
    if (is_rgb) {
      for (size_t i = 0; i < n; ++i) {
        o[3 * i] = p[0][i];
        o[3 * i + 1] = p[1][i];
        o[3 * i + 2] = p[2][i];
      }
      return;
    }
    for (size_t i = 0; i < n; ++i) {
      int y = p[0][i], cb = p[1][i], cr = p[2][i];
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

Info frame_info(const uint8_t* data, size_t size) {
  Decoder d;
  d.data = data;
  d.size = size;
  d.run(nullptr, 0, 0);
  Info info{d.width, d.height, int(d.comps.size()), d.lossless};
  info.h0 = d.comps.empty() ? 0 : d.comps[0].h;
  info.v0 = d.comps.empty() ? 0 : d.comps[0].v;
  info.others_1x1 = true;
  for (size_t k = 1; k < d.comps.size(); ++k)
    if (d.comps[k].h != 1 || d.comps[k].v != 1) info.others_1x1 = false;
  return info;
}

std::vector<uint8_t> decode_tiff_chunk(const uint8_t* data, size_t size,
                                       uint8_t* out, int width, int height,
                                       int colour) {
  Decoder d;
  d.data = data;
  d.size = size;
  d.colour = colour;
  d.end = End::kFakeEoi;   // libtiff's source (tif_jpeg.c)
  d.stop_after_scan = true;
  d.run(out, width, height);
  return d.tables();
}


void decode(const uint8_t* data, size_t size, uint8_t* rgb, int width,
            int height) {
  Decoder d;
  d.data = data;
  d.size = size;
  d.run(rgb, width, height);
}

void decode_colour(const uint8_t* data, size_t size, uint8_t* out,
                   int width, int height, int colour) {
  Decoder d;
  d.data = data;
  d.size = size;
  d.colour = colour;
  d.run(out, width, height);
}

void decode_scaled(const uint8_t* data, size_t size, int n, uint8_t* rgb,
                   int width, int height) {
  if (n < 1 || n > 8) fail("scale " + std::to_string(n) + "/8 out of 1..8");
  Decoder d;
  d.data = data;
  d.size = size;
  d.scale = n;
  d.turbo3 = false;
  d.end = End::kFakeEoi;   // jpeg_stdio_src
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
// width x height x 3 buffer as PIL gives them (mmst_jpeg_decode_scaled at
// n/8 of the size, ceil(width * n / 8) x ceil(height * n / 8), as the JAX
// loader's libjpeg-turbo 2.1 gives them: the two differ only in the edges
// of block smoothing, emit_smoothed). An encoded JPEG is
// malloc'ed and handed to the caller, who frees it with mmst_jpeg_free. An
// error's reason is copied into err (NUL-terminated) and 1 returned.
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
    const mmst_jpeg::Info info = mmst_jpeg::frame_info(data, size);
    *width = info.width;
    *height = info.height;
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

int mmst_jpeg_decode_scaled(const uint8_t* data, size_t size, int n,
                            uint8_t* rgb, int width, int height, char* err,
                            int errlen) {
  try {
    mmst_jpeg::decode_scaled(data, size, n, rgb, width, height);
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
