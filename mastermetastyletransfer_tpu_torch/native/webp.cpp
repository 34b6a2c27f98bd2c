// WebP decoder, with no library beyond libstdc++.
//
// It gives what Pillow gives: Pillow opens every WebP file through
// libwebp's animation decoder (WebPAnimDecoder, in RGBA, not premultiplied)
// and takes its first canvas, and convert("RGB") drops the alpha. So:
//   * the RIFF container is checked as libwebp's demuxer checks it
//     (demux.c: the RIFF size, every chunk's size, VP8X's flags and canvas,
//     ALPH before the image, ANIM before the ANMF frames, each frame's
//     bitstream header and its bounds on the canvas, the image of a still
//     VP8X file exactly the canvas); a file shorter than its RIFF size is
//     refused, as the demuxer refuses partial data; ICCP, EXIF, XMP and
//     unknown chunks are skipped, since Pillow applies none to the pixels;
//   * only the first frame is decoded, at its offset on a canvas of zeros
//     (the animation decoder zero-fills a key frame's canvas and ignores
//     the background colour);
//   * VP8 (lossy, RFC 6386), key frames: the boolean decoder, segments with
//     their quantiser and filter deltas, the mode and reference deltas of
//     the loop filter, 1-8 token partitions, the coefficient token tree
//     with its contexts, libwebp's dequantisation (y2 DC x 2, y2 AC x
//     155/100 floored at 8, uv DC capped at index 117), the inverse WHT and
//     the integer IDCT, every intra mode (16x16, 4x4 with the above-right
//     pixels of the macroblock row above, chroma; the 127 / 129 borders),
//     the simple and the normal loop filter on the whole padded frame in
//     macroblock order (left edge, inner vertical edges, top edge, inner
//     horizontal edges; inner edges skipped on a 16x16 macroblock without
//     coefficients), the crop from macroblocks, then libwebp's "fancy"
//     upsampling of the 4:2:0 chroma and its 14-bit YUV -> RGB (yuv.h);
//   * VP8L (lossless, RFC 9649): the predictor (modes 0-13), cross-colour,
//     subtract-green and colour-indexing transforms (pixel bundling at
//     <= 2, 4 and 16 colours), undone in reverse order of reading; the
//     canonical prefix codes (code-length codes, repeats 16-18, simple
//     codes, a one-symbol code that reads no bits; an incomplete or
//     over-full code refused as libwebp refuses it), the meta prefix
//     (entropy) image, LZ77 with the 120-entry distance map, the colour
//     cache;
//   * ALPH: its values are dropped as convert("RGB") drops them, but a VP8L
//     alpha stream is decoded (and a raw one's size checked) wherever
//     libwebp decodes it, so that a file whose alpha libwebp refuses is
//     refused here too. The filter is only read: it cannot fail, and its
//     values are not used.
// A truncated or corrupt file, one libwebp refuses, and a canvas above
// kMaxPixels throw std::runtime_error naming the reason, the last before
// anything of the image's size is allocated: the decoder reads untrusted
// request bodies. Reads past the end of a buffer read zeros and are
// refused where libwebp refuses them: a VP8 partition as its boolean
// decoder does (eight zero bits, then end of file), a VP8L stream at the
// first bit past its last byte (past 8 bytes in a shorter one).
//
// No function keeps state between calls: concurrent calls from many
// threads are safe.

#include "webp.h"

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace mmst_webp {
namespace {

// PIL refuses an image above twice Image.MAX_IMAGE_PIXELS (89,478,485) as
// a decompression bomb; this decoder refuses it too.
constexpr int64_t kMaxPixels = 2 * int64_t(89478485);

[[noreturn]] void fail(const std::string& why) {
  throw std::runtime_error(why);
}

uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
uint32_t le24(const uint8_t* p) { return le16(p) | (uint32_t(p[2]) << 16); }
uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t(p[3]) << 24); }
bool tag_is(const uint8_t* p, const char* tag) {
  return std::memcmp(p, tag, 4) == 0;
}

void check_pixels(int64_t width, int64_t height, const char* what) {
  if (width * height > kMaxPixels)
    fail(std::string(what) + " of " + std::to_string(width) + " x " +
         std::to_string(height) + " = " + std::to_string(width * height) +
         " pixels is above the limit of " + std::to_string(kMaxPixels) +
         " (decompression bomb)");
}

// ---------------------------------------------------------------- tables

// RFC 6386's tables: dequantisation (DC and AC by index), the coefficient
// probabilities' update probabilities and defaults, the 4x4 modes'
// probabilities by the modes above and to the left (libwebp's mode
// numbering); RFC 9649's distance map, (dy << 4) | (8 - dx).

static const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16,
  17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25,
  25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37,
  38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50,
  51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
  65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77,
  78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93,
  95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151,
  154, 157,
};

static const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
  18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
  32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45,
  46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
  62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88,
  90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
  119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158,
  161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
  213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274,
  279, 284,
};

static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

static const uint8_t kCoeffsProba0[4][8][3][11] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

static const uint8_t kBModesProba[10][10][9] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24,
};

static const uint8_t kCodeToPlane[120] = {
  0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a,
  0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a,
  0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
  0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03,
  0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c,
  0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
  0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b,
  0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
  0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
  0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41,
  0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f,
  0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

// 0-based positions of the 16 coefficients in zigzag order
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
// the band of each coefficient position (17: the one past the last)
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7,
                            0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// Intra modes in libwebp's numbering (the 4x4 probabilities above are
// indexed so); the 16x16 and chroma modes share the first four.
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
  TM_PRED = B_TM_PRED,
  // the DC predictors of a macroblock on the frame's top or left edge
  B_DC_NOTOP = 10, B_DC_NOLEFT, B_DC_NOTOPLEFT
};
const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};

// The VP8L prefix-code alphabets: green + lengths (+ cache), red, blue,
// alpha, distance.
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                          7,  8,  9, 10, 11, 12, 13, 14, 15};

// ------------------------------------------------- VP8 boolean decoder

// libwebp's VP8BitReader, a byte at a time: `range` holds range - 1, and
// `bits` the bits of `value` below its 8-bit window. At the end of the
// buffer it reads eight zero bits once and sets `eof`, which the frame
// decoder checks after each macroblock (partition 0 after each row's
// modes): libwebp refuses the file there.
class BoolDecoder {
 public:
  void init(const uint8_t* p, size_t n) {
    buf_ = p;
    end_ = p + n;
    value_ = 0;
    range_ = 255 - 1;
    bits_ = -8;
    eof_ = false;
    load();
  }
  bool eof() const { return eof_; }

  int get_bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * uint32_t(prob)) >> 8;
    const uint32_t value = uint32_t(value_ >> pos);
    const int bit = value > split;
    if (bit) {
      range -= split;
      value_ -= uint64_t(split + 1) << pos;
    } else {
      range = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }
  // n bits, most significant first, each at probability 1/2
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= uint32_t(get_bit(0x80)) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int value = int(get_value(n));
    return get_value(1) ? -value : value;
  }
  // a coefficient's sign (libwebp's VP8GetSigned: at probability 1/2 the
  // range always renormalises by one bit)
  int get_signed(int v) {
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = range_ >> 1;
    const uint32_t value = uint32_t(value_ >> pos);
    const int32_t mask = int32_t(split - value) >> 31;  // -1 or 0
    bits_ -= 1;
    range_ += uint32_t(mask);
    range_ |= 1;
    value_ -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }

 private:
  void load() {
    if (buf_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *buf_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;  // past the end: keep the shifts defined
    }
  }

  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 0;
  int bits_ = 0;
  bool eof_ = false;
};

// -------------------------------------------------------------- VP8

// A VP8 frame header's size: libwebp's VP8GetInfo (a key frame of profile
// 0-3, shown, its first partition inside the chunk, neither side 0).
void vp8_info(const uint8_t* d, size_t n, size_t chunk_size, int* width,
              int* height) {
  if (n < 10) fail("VP8: truncated frame header");
  if (!(d[3] == 0x9d && d[4] == 0x01 && d[5] == 0x2a))
    fail("VP8: bad start code");
  const uint32_t bits = le24(d);
  if (bits & 1) fail("VP8: not a key frame");
  if (((bits >> 1) & 7) > 3) fail("VP8: unknown profile");
  if (!((bits >> 4) & 1)) fail("VP8: frame not shown");
  if ((bits >> 5) >= chunk_size) fail("VP8: first partition past the chunk");
  *width = int(le16(d + 6) & 0x3fff);
  *height = int(le16(d + 8) & 0x3fff);
  if (*width == 0 || *height == 0) fail("VP8: zero width or height");
}

// libwebp's decoding work buffer: a macroblock's Y (16 x 16), U and V
// (8 x 8) with the row above and the column to the left, BPS bytes a row.
constexpr int BPS = 32;
constexpr int kYOff = BPS * 1 + 8;
constexpr int kUOff = kYOff + BPS * 16 + BPS;
constexpr int kVOff = kUOff + 16;
constexpr int kYuvSize = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}
inline uint8_t avg3(int a, int b, int c) {
  return uint8_t((a + 2 * b + c + 2) >> 2);
}
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

// ---- inverse transforms (libwebp dec.c, bit for bit)

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int c[16];
  int* tmp = c;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int cc = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + cc;
    tmp[2] = b - cc;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = c;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int cc = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + cc) >> 3));
    dst[2] = clip8(dst[2] + ((b - cc) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += BPS;
  }
}

// the inverse Walsh-Hadamard transform of the 16 DCs of a 16x16 block,
// into coefficient 0 of each of its 16 4x4 blocks
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- intra predictors (libwebp dec.c), on the work buffer

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

void predict_luma16(int mode, uint8_t* dst) {
  int dc = 0;
  switch (mode) {
    case B_DC_PRED:
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, 16, (dc + 16) >> 5);
      break;
    case B_DC_NOTOP:
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill(dst, 16, (dc + 8) >> 4);
      break;
    case B_DC_NOLEFT:
      for (int j = 0; j < 16; ++j) dc += dst[j - BPS];
      fill(dst, 16, (dc + 8) >> 4);
      break;
    case B_DC_NOTOPLEFT:
      fill(dst, 16, 0x80);
      break;
    case TM_PRED:
      true_motion(dst, 16);
      break;
    case V_PRED:
      for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 0; j < 16; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1],
                                               16);
      break;
  }
}

void predict_chroma8(int mode, uint8_t* dst) {
  int dc = 0;
  switch (mode) {
    case B_DC_PRED:
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 8, (dc + 8) >> 4);
      break;
    case B_DC_NOTOP:
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      fill(dst, 8, (dc + 4) >> 3);
      break;
    case B_DC_NOLEFT:
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      fill(dst, 8, (dc + 4) >> 3);
      break;
    case B_DC_NOTOPLEFT:
      fill(dst, 8, 0x80);
      break;
    case TM_PRED:
      true_motion(dst, 8);
      break;
    case V_PRED:
      for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1],
                                              8);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict_luma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = dst[-1 - BPS];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          uint8_t(L);
      break;
  }
}

#undef DST

// ---- loop filters (libwebp dec.c), on the frame's planes

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// the simple filter across 16 pixels of an edge: `step` crosses the edge,
// `along` moves along it
void simple_filter16(uint8_t* p, int step, int along, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * along, step, thresh2))
      do_filter2(p + i * along, step);
}

// the normal filter: 6 taps on a macroblock edge, 4 on an inner one
void filter_loop(uint8_t* p, int step, int along, int size, int thresh,
                 int ithresh, int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, step, thresh2, ithresh)) {
      if (hev(p, step, hev_thresh)) {
        do_filter2(p, step);
      } else if (mb_edge) {
        do_filter6(p, step);
      } else {
        do_filter4(p, step);
      }
    }
    p += along;
  }
}

// ---- fancy upsampling and YUV -> RGB (libwebp upsampling.c, yuv.h)

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return (v & ~16383) == 0 ? uint8_t(v >> 6) : v < 0 ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                     mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// Two output rows (bottom_y may be null) from the chroma rows above and
// below them, each pixel's u and v the 9-3-3-1 mean of its four nearest
// chroma samples, packed as libwebp packs them (u low, v high).
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load = [](int u, int v) { return uint32_t(u) | (uint32_t(v) << 16); };
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u[0], top_v[0]);
  uint32_t l_uv = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]);
    const uint32_t uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                 top_dst + (2 * x - 1) * 3);
      yuv_to_rgb(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + 2 * x * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                 bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16,
                 bottom_dst + 2 * x * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16,
                 top_dst + (len - 1) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16,
                 bottom_dst + (len - 1) * 3);
    }
  }
}

// ---- the frame decoder

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};
struct FilterInfo {
  int limit, ilevel, hev_thresh;
  bool inner;
};
struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t uvmode;
  bool is_i4x4, skip;
  int segment;
  uint32_t non_zero_y, non_zero_uv;
};

class Vp8Decoder {
 public:
  // data: the VP8 chunk's payload (with its pad byte, as libwebp takes it);
  // chunk_size: the payload's declared size.
  Vp8Decoder(const uint8_t* data, size_t size, size_t chunk_size)
      : data_(data), size_(size), chunk_size_(chunk_size) {}

  // Decode the frame and write its RGB at (x0, y0) of a canvas of
  // `stride` bytes a row.
  void decode(uint8_t* canvas, size_t stride, int x0, int y0) {
    parse_headers();
    decode_frame();
    emit_rgb(canvas, stride, x0, y0);
  }
  int width() const { return width_; }
  int height() const { return height_; }

 private:
  void parse_headers();
  void parse_segment_header();
  void parse_filter_header();
  void parse_partitions(const uint8_t* buf, size_t size);
  void parse_quant();
  void parse_proba();
  void precompute_filter_strengths();
  void parse_intra_mode(int mb_x, MBData& block);
  int get_coeffs(BoolDecoder& br, const uint8_t* const* bands_probas,
                 int ctx, const int* dq, int n, int16_t* out);
  bool parse_residuals(int mb_x, BoolDecoder& br, MBData& block);
  void decode_frame();
  void reconstruct_row(int mb_y);
  void filter_frame();
  void emit_rgb(uint8_t* canvas, size_t stride, int x0, int y0);


  const uint8_t* data_;
  size_t size_, chunk_size_;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolDecoder br_;                   // partition 0
  std::vector<BoolDecoder> parts_;   // token partitions
  int num_parts_minus_one_ = 0;
  // segment header
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int seg_quantizer_[4] = {0, 0, 0, 0}, seg_filter_[4] = {0, 0, 0, 0};
  uint8_t segment_proba_[3] = {255, 255, 255};
  // filter header
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  FilterInfo fstrengths_[4][2] = {};
  QuantMatrix dqm_[4] = {};
  uint8_t coeff_proba_[4][8][3][11] = {};
  // by type, the probabilities of coefficient position 0-16 (through its
  // band) and context: probas_[t][pos * 3 + ctx]
  const uint8_t* probas_[4][17 * 3] = {};
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  // per row and per column state
  std::vector<uint8_t> intra_t_;     // 4 modes a macroblock column
  uint8_t intra_l_[4] = {0, 0, 0, 0};
  std::vector<uint8_t> nz_t_, nz_dc_t_;  // non-zero flags above
  uint8_t nz_l_ = 0, nz_dc_l_ = 0;       // and to the left
  std::vector<MBData> mb_data_;      // one macroblock row
  std::vector<FilterInfo> finfo_;    // every macroblock
  // reconstruction
  uint8_t yuv_b_[kYuvSize] = {};
  std::vector<uint8_t> y_t_, u_t_, v_t_;  // unfiltered rows above
  std::vector<uint8_t> ybuf_, ubuf_, vbuf_;  // the padded frame
  int y_stride_ = 0, uv_stride_ = 0;
};

void Vp8Decoder::parse_headers() {
  vp8_info(data_, size_, chunk_size_, &width_, &height_);
  check_pixels(width_, height_, "VP8 frame");
  const uint32_t bits = le24(data_);
  const size_t partition_length = bits >> 5;
  const uint8_t* buf = data_ + 10;
  size_t buf_size = size_ - 10;
  mb_w_ = (width_ + 15) >> 4;
  mb_h_ = (height_ + 15) >> 4;
  if (partition_length > buf_size) fail("VP8: bad partition length");
  br_.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  br_.get_value(1);  // colour space
  br_.get_value(1);  // clamping type: libwebp always clamps
  parse_segment_header();
  if (br_.eof()) fail("VP8: cannot parse segment header");
  parse_filter_header();
  if (br_.eof()) fail("VP8: cannot parse filter header");
  parse_partitions(buf, buf_size);
  parse_quant();
  br_.get_value(1);  // update_proba: ignored for a key frame
  parse_proba();
}

void Vp8Decoder::parse_segment_header() {
  use_segment_ = br_.get_value(1);
  if (use_segment_) {
    update_map_ = br_.get_value(1);
    if (br_.get_value(1)) {  // update data
      absolute_delta_ = br_.get_value(1);
      for (int s = 0; s < 4; ++s)
        seg_quantizer_[s] = br_.get_value(1) ? br_.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        seg_filter_[s] = br_.get_value(1) ? br_.get_signed_value(6) : 0;
    }
    if (update_map_)
      for (int s = 0; s < 3; ++s)
        segment_proba_[s] = br_.get_value(1) ? uint8_t(br_.get_value(8)) : 255;
  } else {
    update_map_ = false;
  }
}

void Vp8Decoder::parse_filter_header() {
  simple_ = br_.get_value(1);
  level_ = int(br_.get_value(6));
  sharpness_ = int(br_.get_value(3));
  use_lf_delta_ = br_.get_value(1);
  if (use_lf_delta_ && br_.get_value(1)) {  // update the deltas
    for (int i = 0; i < 4; ++i)
      if (br_.get_value(1)) ref_lf_delta_[i] = br_.get_signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br_.get_value(1)) mode_lf_delta_[i] = br_.get_signed_value(6);
  }
  filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
}

void Vp8Decoder::parse_partitions(const uint8_t* buf, size_t size) {
  const uint8_t* sz = buf;
  const uint8_t* buf_end = buf + size;
  num_parts_minus_one_ = (1 << br_.get_value(2)) - 1;
  const size_t last_part = size_t(num_parts_minus_one_);
  if (size < 3 * last_part) fail("VP8: cannot parse partitions");
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = size - last_part * 3;
  parts_.resize(last_part + 1);
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = le24(sz);
    if (psize > size_left) psize = size_left;
    parts_[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts_[last_part].init(part_start, size_left);
  if (part_start >= buf_end) fail("VP8: cannot parse partitions");
}

void Vp8Decoder::parse_quant() {
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  const int base_q0 = int(br_.get_value(7));
  const int dqy1_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
  const int dqy2_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
  const int dqy2_ac = br_.get_value(1) ? br_.get_signed_value(4) : 0;
  const int dquv_dc = br_.get_value(1) ? br_.get_signed_value(4) : 0;
  const int dquv_ac = br_.get_value(1) ? br_.get_signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment_) {
      q = seg_quantizer_[i];
      if (!absolute_delta_) q += base_q0;
    } else {
      if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      }
      q = base_q0;
    }
    QuantMatrix& m = dqm_[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 for every x of the table, as (x * 101581) >> 16
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void Vp8Decoder::parse_proba() {
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          coeff_proba_[t][b][c][p] =
              br_.get_bit(kCoeffsUpdateProba[t][b][c][p])
                  ? uint8_t(br_.get_value(8))
                  : kCoeffsProba0[t][b][c][p];
  use_skip_proba_ = br_.get_value(1);
  if (use_skip_proba_) skip_p_ = int(br_.get_value(8));
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 17; ++b)
      for (int c = 0; c < 3; ++c)
        probas_[t][b * 3 + c] = coeff_proba_[t][kBands[b]][c];
}

void Vp8Decoder::precompute_filter_strengths() {
  if (filter_type_ == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment_) {
      base_level = seg_filter_[s];
      if (!absolute_delta_) base_level += level_;
    } else {
      base_level = level_;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FilterInfo& info = fstrengths_[s][i4x4];
      int level = base_level;
      if (use_lf_delta_) {
        level += ref_lf_delta_[0];
        if (i4x4) level += mode_lf_delta_[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (sharpness_ > 0) {
          ilevel >>= sharpness_ > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;  // no filtering
      }
      info.inner = i4x4;
    }
  }
}

void Vp8Decoder::parse_intra_mode(int mb_x, MBData& block) {
  uint8_t* const top = intra_t_.data() + 4 * mb_x;
  uint8_t* const left = intra_l_;
  if (update_map_) {
    block.segment = !br_.get_bit(segment_proba_[0])
                        ? br_.get_bit(segment_proba_[1])
                        : br_.get_bit(segment_proba_[2]) + 2;
  } else {
    block.segment = 0;
  }
  block.skip = use_skip_proba_ ? br_.get_bit(skip_p_) : false;
  block.is_i4x4 = !br_.get_bit(145);
  if (!block.is_i4x4) {
    const int ymode = br_.get_bit(156)
                          ? (br_.get_bit(128) ? TM_PRED : H_PRED)
                          : (br_.get_bit(163) ? V_PRED : DC_PRED);
    block.imodes[0] = uint8_t(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* const prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br_.get_bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br_.get_bit(prob[i])];
        ymode = -i;
        top[x] = uint8_t(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = uint8_t(ymode);
    }
  }
  block.uvmode = uint8_t(!br_.get_bit(142)   ? DC_PRED
                         : !br_.get_bit(114) ? V_PRED
                         : br_.get_bit(183)  ? TM_PRED
                                             : H_PRED);
}

// The tokens of one 4x4 block from position n, dequantised into `out` in
// raster order; returns the position after the last non-zero one (16 when
// the block runs to its end).
int Vp8Decoder::get_coeffs(BoolDecoder& br, const uint8_t* const* probas,
                           int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = probas[n * 3 + ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;  // end of block
    while (!br.get_bit(p[1])) {       // a zero
      p = probas[++n * 3 + 0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = probas[(n + 1) * 3 + 1];
    } else {
      if (!br.get_bit(p[3])) {
        if (!br.get_bit(p[4])) {
          v = 2;
        } else {
          v = 3 + br.get_bit(p[5]);
        }
      } else if (!br.get_bit(p[6])) {
        if (!br.get_bit(p[7])) {
          v = 5 + br.get_bit(159);
        } else {
          v = 7 + 2 * br.get_bit(165);
          v += br.get_bit(145);
        }
      } else {
        const int bit1 = br.get_bit(p[8]);
        const int bit0 = br.get_bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
          v += v + br.get_bit(*tab);
        v += 3 + (8 << cat);
      }
      p = probas[(n + 1) * 3 + 2];
    }
    out[kZigzag[n]] = int16_t(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

bool Vp8Decoder::parse_residuals(int mb_x, BoolDecoder& br, MBData& block) {
  const uint8_t* const(*probas)[17 * 3] = probas_;
  const QuantMatrix& q = dqm_[block.segment];
  int16_t* dst = block.coeffs;
  std::memset(dst, 0, sizeof(block.coeffs));
  const uint8_t* const* ac_proba;
  int first;
  uint8_t& nz_t = nz_t_[mb_x];
  uint8_t& nz_dc_t = nz_dc_t_[mb_x];
  if (!block.is_i4x4) {  // the DCs through the WHT
    int16_t dc[16] = {0};
    const int ctx = nz_dc_t + nz_dc_l_;
    const int nz = get_coeffs(br, probas[1], ctx, q.y2, 0, dc);
    nz_dc_t = nz_dc_l_ = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {  // only the DC: the WHT's simplified form
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
    }
    first = 1;
    ac_proba = probas[0];
  } else {
    first = 0;
    ac_proba = probas[3];
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  uint8_t tnz = nz_t & 0x0f;
  uint8_t lnz = nz_l_ & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = uint8_t((tnz >> 1) | (l << 7));
      nz_coeffs = (nz_coeffs << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = uint8_t((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = uint8_t(nz_t >> (4 + ch));
    lnz = uint8_t(nz_l_ >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, probas[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = uint8_t((tnz >> 1) | (l << 3));
        nz_coeffs = (nz_coeffs << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = uint8_t((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= uint32_t(tnz << 4) << ch;
    out_l_nz |= uint32_t(lnz & 0xf0) << ch;
  }
  nz_t = uint8_t(out_t_nz);
  nz_l_ = uint8_t(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

void Vp8Decoder::decode_frame() {
  precompute_filter_strengths();
  intra_t_.assign(size_t(4) * mb_w_, B_DC_PRED);
  nz_t_.assign(size_t(mb_w_), 0);
  nz_dc_t_.assign(size_t(mb_w_), 0);
  mb_data_.resize(size_t(mb_w_));
  finfo_.resize(size_t(mb_w_) * mb_h_);
  y_t_.assign(size_t(16) * mb_w_, 0);
  u_t_.assign(size_t(8) * mb_w_, 0);
  v_t_.assign(size_t(8) * mb_w_, 0);
  y_stride_ = 16 * mb_w_;
  uv_stride_ = 8 * mb_w_;
  ybuf_.assign(size_t(y_stride_) * 16 * mb_h_, 0);
  ubuf_.assign(size_t(uv_stride_) * 8 * mb_h_, 0);
  vbuf_.assign(size_t(uv_stride_) * 8 * mb_h_, 0);
  for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
    BoolDecoder& token_br = parts_[size_t(mb_y & num_parts_minus_one_)];
    std::memset(intra_l_, B_DC_PRED, 4);
    nz_l_ = nz_dc_l_ = 0;
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x)
      parse_intra_mode(mb_x, mb_data_[size_t(mb_x)]);
    if (br_.eof()) fail("VP8: premature end of partition 0");
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      MBData& block = mb_data_[size_t(mb_x)];
      bool skip = use_skip_proba_ ? block.skip : false;
      if (!skip) {
        skip = parse_residuals(mb_x, token_br, block);
      } else {
        nz_l_ = nz_t_[size_t(mb_x)] = 0;
        if (!block.is_i4x4) nz_dc_l_ = nz_dc_t_[size_t(mb_x)] = 0;
        block.non_zero_y = block.non_zero_uv = 0;
      }
      if (filter_type_ > 0) {
        FilterInfo& f = finfo_[size_t(mb_y) * mb_w_ + mb_x];
        f = fstrengths_[block.segment][block.is_i4x4];
        f.inner = f.inner || !skip;
      }
      if (token_br.eof()) fail("VP8: premature end of a token partition");
    }
    reconstruct_row(mb_y);
  }
  if (filter_type_ > 0) filter_frame();
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? B_DC_NOTOPLEFT : B_DC_NOLEFT;
    return mb_y == 0 ? B_DC_NOTOP : B_DC_PRED;
  }
  return mode;
}

// one 4x4 block's residual, by what its coefficients hold (libwebp's
// DoTransform: the DC-only and three-coefficient forms equal the full one)
inline void add_residual(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits >> 30) transform_one(src, dst);
}

void Vp8Decoder::reconstruct_row(int mb_y) {
  uint8_t* const y_dst = yuv_b_ + kYOff;
  uint8_t* const u_dst = yuv_b_ + kUOff;
  uint8_t* const v_dst = yuv_b_ + kVOff;
  // the left-most macroblock's left column
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {  // the top row, and its corner and above-right, are 127
    std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - BPS - 1, 127, 8 + 1);
    std::memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
    const MBData& block = mb_data_[size_t(mb_x)];
    if (mb_x > 0) {  // the previous macroblock's right columns become left
      for (int j = -1; j < 16; ++j)
        std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    uint8_t* const top_y = y_t_.data() + 16 * mb_x;
    uint8_t* const top_u = u_t_.data() + 8 * mb_x;
    uint8_t* const top_v = v_t_.data() + 8 * mb_x;
    const int16_t* const coeffs = block.coeffs;
    uint32_t bits = block.non_zero_y;
    if (mb_y > 0) {
      std::memcpy(y_dst - BPS, top_y, 16);
      std::memcpy(u_dst - BPS, top_u, 8);
      std::memcpy(v_dst - BPS, top_v, 8);
    }
    if (block.is_i4x4) {
      uint8_t* const top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w_ - 1) {  // the right edge: the last pixel above
          std::memset(top_right, top_y[15], 4);
        } else {
          std::memcpy(top_right, top_y + 16, 4);
        }
      }
      // the above-right pixels of the right column's lower blocks are the
      // macroblock's own above-right ones
      for (int r = 1; r <= 3; ++r)
        std::memcpy(top_right + r * 4 * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict_luma4(block.imodes[n], dst);
        add_residual(bits, coeffs + n * 16, dst);
      }
    } else {
      predict_luma16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
      if (bits != 0)
        for (int n = 0; n < 16; ++n, bits <<= 2)
          add_residual(bits, coeffs + n * 16,
                       y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    {
      const uint32_t bits_uv = block.non_zero_uv;
      const int mode = check_mode(mb_x, mb_y, block.uvmode);
      predict_chroma8(mode, u_dst);
      predict_chroma8(mode, v_dst);
      for (int ch = 0; ch < 2; ++ch) {
        uint8_t* const dst = ch ? v_dst : u_dst;
        const int16_t* const src = coeffs + 16 * 16 + ch * 4 * 16;
        if (((bits_uv >> (8 * ch)) & 0xff) == 0) continue;
        for (int b = 0; b < 4; ++b)
          transform_one(src + b * 16, dst + (b & 1) * 4 + (b >> 1) * 4 * BPS);
      }
    }
    if (mb_y < mb_h_ - 1) {  // keep the unfiltered bottom rows for below
      std::memcpy(top_y, y_dst + 15 * BPS, 16);
      std::memcpy(top_u, u_dst + 7 * BPS, 8);
      std::memcpy(top_v, v_dst + 7 * BPS, 8);
    }
    for (int j = 0; j < 16; ++j)
      std::memcpy(&ybuf_[size_t(mb_y * 16 + j) * y_stride_ + 16 * mb_x],
                  y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(&ubuf_[size_t(mb_y * 8 + j) * uv_stride_ + 8 * mb_x],
                  u_dst + j * BPS, 8);
      std::memcpy(&vbuf_[size_t(mb_y * 8 + j) * uv_stride_ + 8 * mb_x],
                  v_dst + j * BPS, 8);
    }
  }
}

void Vp8Decoder::filter_frame() {
  const int ys = y_stride_, uvs = uv_stride_;
  for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const FilterInfo& f = finfo_[size_t(mb_y) * mb_w_ + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      uint8_t* const y = &ybuf_[size_t(mb_y) * 16 * ys + mb_x * 16];
      if (filter_type_ == 1) {  // simple: luma only
        if (mb_x > 0) simple_filter16(y, 1, ys, limit + 4);
        if (f.inner)
          for (int k = 1; k <= 3; ++k)
            simple_filter16(y + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_filter16(y, ys, 1, limit + 4);
        if (f.inner)
          for (int k = 1; k <= 3; ++k)
            simple_filter16(y + 4 * k * ys, ys, 1, limit);
      } else {  // normal
        uint8_t* const u = &ubuf_[size_t(mb_y) * 8 * uvs + mb_x * 8];
        uint8_t* const v = &vbuf_[size_t(mb_y) * 8 * uvs + mb_x * 8];
        const int il = f.ilevel, ht = f.hev_thresh;
        if (mb_x > 0) {
          filter_loop(y, 1, ys, 16, limit + 4, il, ht, true);
          filter_loop(u, 1, uvs, 8, limit + 4, il, ht, true);
          filter_loop(v, 1, uvs, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k)
            filter_loop(y + 4 * k, 1, ys, 16, limit, il, ht, false);
          filter_loop(u + 4, 1, uvs, 8, limit, il, ht, false);
          filter_loop(v + 4, 1, uvs, 8, limit, il, ht, false);
        }
        if (mb_y > 0) {
          filter_loop(y, ys, 1, 16, limit + 4, il, ht, true);
          filter_loop(u, uvs, 1, 8, limit + 4, il, ht, true);
          filter_loop(v, uvs, 1, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k)
            filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
          filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
          filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
        }
      }
    }
  }
}

// The cropped frame to RGB, row pairs as libwebp's EmitFancyRGB emits the
// whole frame: row 0 and an even height's last row from one chroma row,
// rows 2k-1 and 2k from chroma rows k-1 and k.
void Vp8Decoder::emit_rgb(uint8_t* canvas, size_t stride, int x0, int y0) {
  const int w = width_, h = height_;
  uint8_t* dst = canvas + size_t(y0) * stride + size_t(x0) * 3;
  const uint8_t* cur_y = ybuf_.data();
  const uint8_t* cur_u = ubuf_.data();
  const uint8_t* cur_v = vbuf_.data();
  upsample_pair(cur_y, nullptr, cur_u, cur_v, cur_u, cur_v, dst, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const uint8_t* top_u = cur_u;
    const uint8_t* top_v = cur_v;
    cur_u += uv_stride_;
    cur_v += uv_stride_;
    dst += 2 * stride;
    cur_y += 2 * y_stride_;
    upsample_pair(cur_y - y_stride_, cur_y, top_u, top_v, cur_u, cur_v,
                  dst - stride, dst, w);
  }
  cur_y += y_stride_;
  if (!(h & 1))
    upsample_pair(cur_y, nullptr, cur_u, cur_v, cur_u, cur_v, dst + stride,
                  nullptr, w);
}

// ------------------------------------------------------------- VP8L

// libwebp's VP8LBitReader read as a position in the stream, least
// significant bit first; bits past the end read as zero, and the stream
// has ended once a read goes past its last byte (past its first 8 bytes
// where it is shorter: libwebp's 64-bit window holds that much).
class LBitReader {
 public:
  LBitReader(const uint8_t* p, size_t n) : buf_(p), len_(n) {}
  uint32_t peek(int n) const {  // n <= 32
    const size_t byte = pos_ >> 3;
    uint64_t v = 0;
    if (byte + 8 <= len_) {
      std::memcpy(&v, buf_ + byte, 8);  // little-endian host
    } else {
      for (size_t i = 0; i < 8 && byte + i < len_; ++i)
        v |= uint64_t(buf_[byte + i]) << (8 * i);
    }
    v >>= pos_ & 7;
    return uint32_t(v & ((uint64_t(1) << n) - 1));
  }
  void skip(int n) { pos_ += size_t(n); }
  uint32_t read(int n) {
    const uint32_t v = peek(n);
    pos_ += size_t(n);
    return v;
  }
  bool eos() const { return pos_ > std::max(len_, size_t(8)) * 8; }

 private:
  const uint8_t* buf_;
  size_t len_;
  size_t pos_ = 0;
};

// A canonical prefix code: an 8-bit table of the codes up to 8 bits long,
// the rest decoded length by length.
struct HuffTree {
  int single = -1;                 // the symbol of a one-symbol code
  uint32_t root[256] = {};         // (length << 16) | symbol; 0: longer
  uint16_t count[16] = {};
  std::vector<uint16_t> sorted;    // symbols by length, then value

  int read(LBitReader& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek(15);
    const uint32_t e = root[bits & 255];
    if (e >> 16) {
      br.skip(int(e >> 16));
      return int(e & 0xffff);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (bits >> (len - 1)) & 1;
      const int n = count[len];
      if (code - n < first) {
        br.skip(len);
        return sorted[size_t(index + code - first)];
      }
      index += n;
      first = (first + n) << 1;
      code <<= 1;
    }
    return 0;  // unreachable: the code is complete
  }
};

// Build a code from its lengths as libwebp's BuildHuffmanTable accepts
// them: not all zero; one symbol of any length reads no bits; otherwise
// the code must be complete. Returns 0 for a code libwebp refuses, 1 for
// a one-symbol code, 2 for any other (t may be null: the check alone).
int build_tree(const int* lengths, int n, HuffTree* t) {
  int count[16] = {0};
  int nonzero = 0, last = 0;
  for (int s = 0; s < n; ++s) {
    if (lengths[s] < 0 || lengths[s] > 15) return 0;
    ++count[lengths[s]];
    if (lengths[s]) {
      ++nonzero;
      last = s;
    }
  }
  if (nonzero == 0) return 0;
  if (nonzero == 1) {
    if (t) t->single = last;
    return 1;
  }
  int left = 1;
  for (int len = 1; len <= 15; ++len) {
    left = (left << 1) - count[len];
    if (left < 0) return 0;  // over-subscribed
  }
  if (left != 0) return 0;   // incomplete
  if (!t) return 2;
  t->single = -1;
  int offset[17];
  offset[1] = 0;
  for (int len = 1; len <= 15; ++len) {
    t->count[len] = uint16_t(count[len]);
    offset[len + 1] = offset[len] + count[len];
  }
  t->sorted.assign(size_t(nonzero), 0);
  for (int s = 0; s < n; ++s)
    if (lengths[s]) t->sorted[size_t(offset[lengths[s]]++)] = uint16_t(s);
  // the codes of up to 8 bits into the table, their bits reversed
  int code = 0, index = 0;
  for (int len = 1; len <= 8; ++len) {
    for (int i = 0; i < count[len]; ++i, ++code, ++index) {
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> (len - 1 - b)) & 1) << b;
      const uint32_t e = (uint32_t(len) << 16) | t->sorted[size_t(index)];
      for (int k = rev; k < 256; k += 1 << len) t->root[k] = e;
    }
    code <<= 1;
  }
  return 2;
}

struct HTreeGroup {
  HuffTree trees[5];  // green (+ lengths + cache), red, blue, alpha, dist
};

inline int sub_sample_size(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1,
                                          uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = int((c0 >> s) & 0xff) + int((c1 >> s) & 0xff) -
                  int((c2 >> s) & 0xff);
    out |= uint32_t(clip255(v)) << s;
  }
  return out;
}
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1,
                                          uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = int((ave >> s) & 0xff), b = int((c2 >> s) & 0xff);
    out |= uint32_t(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int ac = int((a >> s) & 0xff), bc = int((b >> s) & 0xff),
              cc = int((c >> s) & 0xff);
    pa_minus_pb += std::abs(bc - cc) - std::abs(ac - cc);
  }
  return pa_minus_pb <= 0 ? a : b;
}

// the prediction of mode m from the left pixel and the row above (upper
// points at the pixel above)
inline uint32_t predict(int m, uint32_t left, const uint32_t* upper) {
  switch (m) {
    case 1: return left;
    case 2: return upper[0];
    case 3: return upper[1];
    case 4: return upper[-1];
    case 5: return average2(average2(left, upper[1]), upper[0]);
    case 6: return average2(left, upper[-1]);
    case 7: return average2(left, upper[0]);
    case 8: return average2(upper[-1], upper[0]);
    case 9: return average2(upper[0], upper[1]);
    case 10:
      return average2(average2(left, upper[-1]), average2(upper[0], upper[1]));
    case 11: return select_pred(upper[0], left, upper[-1]);
    case 12: return clamped_add_subtract_full(left, upper[0], upper[-1]);
    case 13: return clamped_add_subtract_half(left, upper[0], upper[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp takes them
  }
}

class Vp8lDecoder {
 public:
  Vp8lDecoder(const uint8_t* p, size_t n) : br_(p, n) {}

  // The 5-byte header: signature, size, alpha bit, version.
  void header(int* width, int* height) {
    if (br_.read(8) != 0x2f) fail("VP8L: bad signature");
    *width = int(br_.read(14)) + 1;
    *height = int(br_.read(14)) + 1;
    br_.read(1);  // alpha is used
    if (br_.read(3) != 0) fail("VP8L: unknown version");
    if (br_.eos()) fail("VP8L: truncated header");
  }

  // The image of width x height that follows (its transforms, codes and
  // pixels), as ARGB.
  std::vector<uint32_t> decode(int width, int height) {
    std::vector<uint32_t> argb;
    decode_stream(width, height, true, &argb);
    return argb;
  }

  // The same for an ALPH chunk's stream. Where libwebp decodes it a byte
  // a pixel (one transform, colour indexing, no colour cache, red, blue and
  // alpha codes of one symbol in every group it keeps: its
  // DecodeAlphaData), it accepts a stream whose last symbol reads past the
  // end, once every pixel is decoded; so does this.
  void decode_alpha(int width, int height) {
    alpha_ = true;
    decode(width, height);
  }

 private:
  enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2,
         COLOR_INDEXING = 3 };
  struct Transform {
    int type, bits, xsize, ysize;
    std::vector<uint32_t> data;
  };
  struct Codes {
    int huffman_bits = 0, huffman_xsize = 0;
    std::vector<uint32_t> huffman_image;  // group index per tile
    std::vector<HTreeGroup> groups;
    // red, blue and alpha codes of one symbol in every group libwebp keeps
    bool rba_single = true;
  };

  void truncated() const {
    if (br_.eos()) fail("VP8L: truncated bitstream");
  }
  void decode_stream(int xsize, int ysize, bool level0,
                     std::vector<uint32_t>* out);
  void read_transform(int* xsize, int ysize);
  void read_codes(int xsize, int ysize, int cache_bits, bool allow_meta,
                  Codes* codes);
  int read_code(int alphabet_size, std::vector<int>& lengths, HuffTree* t);
  void read_code_lengths(const int* cl_lengths, int num_symbols,
                         std::vector<int>& lengths);
  void decode_pixels(const Codes& codes, int width, int height,
                     int cache_bits, bool lenient_end, uint32_t* data);
  void inverse_transforms(int height, std::vector<uint32_t>* px);

  LBitReader br_;
  std::vector<Transform> transforms_;
  unsigned transforms_seen_ = 0;
  bool alpha_ = false;
};

void Vp8lDecoder::decode_stream(int xsize, int ysize, bool level0,
                                std::vector<uint32_t>* out) {
  int txsize = xsize;
  if (level0)
    while (br_.read(1)) {
      read_transform(&txsize, ysize);
      truncated();
    }
  int cache_bits = 0;
  if (br_.read(1)) {
    cache_bits = int(br_.read(4));
    if (cache_bits < 1 || cache_bits > 11)
      fail("VP8L: colour cache of " + std::to_string(cache_bits) + " bits");
  }
  Codes codes;
  read_codes(txsize, ysize, cache_bits, level0, &codes);
  const bool eight_bit = level0 && alpha_ && transforms_.size() == 1 &&
                         transforms_[0].type == COLOR_INDEXING &&
                         cache_bits == 0 && codes.rba_single;
  out->assign(size_t(txsize) * size_t(ysize), 0);
  decode_pixels(codes, txsize, ysize, cache_bits, eight_bit, out->data());
  if (!eight_bit) truncated();
  if (level0) inverse_transforms(ysize, out);
}

void Vp8lDecoder::read_transform(int* xsize, int ysize) {
  const int type = int(br_.read(2));
  if (transforms_seen_ & (1u << type)) fail("VP8L: a transform repeated");
  transforms_seen_ |= 1u << type;
  Transform t;
  t.type = type;
  t.xsize = *xsize;
  t.ysize = ysize;
  t.bits = 0;
  switch (type) {
    case PREDICTOR:
    case CROSS_COLOR:
      t.bits = int(br_.read(3)) + 2;
      decode_stream(sub_sample_size(t.xsize, t.bits),
                    sub_sample_size(t.ysize, t.bits), false, &t.data);
      break;
    case COLOR_INDEXING: {
      const int num_colors = int(br_.read(8)) + 1;
      t.bits = num_colors > 16 ? 0
               : num_colors > 4 ? 1
               : num_colors > 2 ? 2
                                : 3;
      *xsize = sub_sample_size(t.xsize, t.bits);
      std::vector<uint32_t> palette;
      decode_stream(num_colors, 1, false, &palette);
      // the palette is coded as differences; indices past it are zero
      t.data.assign(size_t(1) << (8 >> t.bits), 0);
      t.data[0] = palette[0];
      for (int i = 1; i < num_colors; ++i)
        t.data[size_t(i)] =
            add_pixels(palette[size_t(i)], t.data[size_t(i - 1)]);
      break;
    }
    case SUBTRACT_GREEN:
      break;
  }
  transforms_.push_back(std::move(t));
}

void Vp8lDecoder::read_codes(int xsize, int ysize, int cache_bits,
                             bool allow_meta, Codes* codes) {
  int num_groups_max = 1;
  if (allow_meta && br_.read(1)) {
    codes->huffman_bits = int(br_.read(3)) + 2;
    codes->huffman_xsize = sub_sample_size(xsize, codes->huffman_bits);
    decode_stream(codes->huffman_xsize,
                  sub_sample_size(ysize, codes->huffman_bits), false,
                  &codes->huffman_image);
    for (uint32_t& v : codes->huffman_image) {
      v = (v >> 8) & 0xffff;
      num_groups_max = std::max(num_groups_max, int(v) + 1);
    }
  }
  truncated();
  // Every group's codes are read and checked; only the groups the image
  // uses are kept, renumbered in order of their index.
  std::vector<int> mapping(size_t(num_groups_max), -1);
  if (codes->huffman_bits == 0) {
    mapping[0] = 0;
  } else {
    for (uint32_t v : codes->huffman_image) mapping[v] = 0;
  }
  int used = 0;
  for (int& m : mapping)
    if (m == 0) m = used++;
  for (uint32_t& v : codes->huffman_image) v = uint32_t(mapping[v]);
  codes->groups.resize(size_t(used));
  // libwebp keeps every group up to the largest index, or only the used
  // ones where that index is above 1000 or the image's pixel count
  const bool keeps_all = !(num_groups_max > 1000 ||
                           int64_t(num_groups_max) > int64_t(xsize) * ysize);
  std::vector<int> lengths;
  for (int i = 0; i < num_groups_max; ++i) {
    HTreeGroup* g = mapping[size_t(i)] >= 0
                        ? &codes->groups[size_t(mapping[size_t(i)])]
                        : nullptr;
    for (int j = 0; j < 5; ++j) {
      int alphabet_size = kAlphabetSize[j];
      if (j == 0 && cache_bits > 0) alphabet_size += 1 << cache_bits;
      const int kind = read_code(alphabet_size, lengths,
                                 g ? &g->trees[j] : nullptr);
      if ((g || keeps_all) && j >= 1 && j <= 3 && kind != 1)
        codes->rba_single = false;
    }
  }
}

int Vp8lDecoder::read_code(int alphabet_size, std::vector<int>& lengths,
                           HuffTree* t) {
  lengths.assign(size_t(std::max(alphabet_size, 256)), 0);
  if (br_.read(1)) {  // simple: one or two symbols
    const int num_symbols = int(br_.read(1)) + 1;
    const int first_bits = br_.read(1) ? 8 : 1;
    lengths[br_.read(first_bits)] = 1;
    if (num_symbols == 2) lengths[br_.read(8)] = 1;
  } else {
    int cl_lengths[19] = {0};
    const int num_codes = int(br_.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i)
      cl_lengths[kCodeLengthCodeOrder[i]] = int(br_.read(3));
    read_code_lengths(cl_lengths, alphabet_size, lengths);
  }
  truncated();
  const int kind = build_tree(lengths.data(), alphabet_size, t);
  if (!kind) fail("VP8L: invalid prefix code");
  return kind;
}

void Vp8lDecoder::read_code_lengths(const int* cl_lengths, int num_symbols,
                                    std::vector<int>& lengths) {
  HuffTree cl;
  if (!build_tree(cl_lengths, 19, &cl))
    fail("VP8L: invalid code-length code");
  int max_symbol;
  if (br_.read(1)) {  // the count of code lengths is given
    const int length_nbits = 2 + 2 * int(br_.read(3));
    max_symbol = 2 + int(br_.read(length_nbits));
    if (max_symbol > num_symbols) fail("VP8L: too many code lengths");
  } else {
    max_symbol = num_symbols;
  }
  int prev_code_len = 8;
  int symbol = 0;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    if (br_.eos()) fail("VP8L: truncated bitstream");
    const int code_len = cl.read(br_);
    if (code_len < 16) {
      lengths[size_t(symbol++)] = code_len;
      if (code_len != 0) prev_code_len = code_len;
    } else {
      const int slot = code_len - 16;
      static const int kExtraBits[3] = {2, 3, 7};
      static const int kRepeatOffsets[3] = {3, 3, 11};
      int repeat = int(br_.read(kExtraBits[slot])) + kRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) fail("VP8L: code lengths overrun");
      const int length = code_len == 16 ? prev_code_len : 0;
      while (repeat-- > 0) lengths[size_t(symbol++)] = length;
    }
  }
}

// a length or distance prefix symbol's value
inline int copy_distance(int symbol, LBitReader& br) {
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + int(br.read(extra_bits)) + 1;
}

inline int plane_code_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;  // below 1 where xsize is very small
}

void Vp8lDecoder::decode_pixels(const Codes& codes, int width, int height,
                                int cache_bits, bool lenient_end,
                                uint32_t* data) {
  const size_t total = size_t(width) * size_t(height);
  std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0, 0);
  const int cache_shift = 32 - cache_bits;
  const int cache_limit = 256 + 24 + (cache_bits ? 1 << cache_bits : 0);
  const int hbits = codes.huffman_bits;
  auto group_at = [&](int col, int row) -> const HTreeGroup& {
    if (hbits == 0) return codes.groups[0];
    return codes.groups[codes.huffman_image[size_t(row >> hbits) *
                                                codes.huffman_xsize +
                                            size_t(col >> hbits)]];
  };
  auto insert = [&](size_t from, size_t to) {
    if (!cache_bits) return;
    for (size_t i = from; i < to; ++i)
      cache[(0x1e35a7bdu * data[i]) >> cache_shift] = data[i];
  };
  size_t pos = 0;
  int col = 0, row = 0;
  while (pos < total) {
    if (br_.eos()) fail("VP8L: truncated bitstream");
    const HTreeGroup& g = group_at(col, row);
    const int code = g.trees[0].read(br_);
    if (code < 256) {  // a literal
      const int red = g.trees[1].read(br_);
      const int blue = g.trees[2].read(br_);
      const int alpha = g.trees[3].read(br_);
      data[pos] = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) |
                  (uint32_t(code) << 8) | uint32_t(blue);
      insert(pos, pos + 1);
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < 256 + 24) {  // a backward reference
      const int length = copy_distance(code - 256, br_);
      const int dist_symbol = g.trees[4].read(br_);
      const int dist =
          plane_code_to_distance(width, copy_distance(dist_symbol, br_));
      if (!lenient_end && br_.eos()) fail("VP8L: truncated bitstream");
      if (pos < size_t(dist) || total - pos < size_t(length))
        fail("VP8L: backward reference out of the image");
      for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      insert(pos, pos + length);
      pos += size_t(length);
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
    } else if (code < cache_limit) {  // a colour cache entry
      data[pos] = cache[size_t(code - 256 - 24)];
      insert(pos, pos + 1);
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else {
      fail("VP8L: invalid symbol");
    }
  }
}

void Vp8lDecoder::inverse_transforms(int height, std::vector<uint32_t>* px) {
  for (int i = int(transforms_.size()) - 1; i >= 0; --i) {
    const Transform& t = transforms_[size_t(i)];
    const int w = t.xsize;
    uint32_t* d = px->data();
    switch (t.type) {
      case PREDICTOR: {
        const int tiles_per_row = sub_sample_size(w, t.bits);
        // the first row: black, then the left pixel
        d[0] = add_pixels(d[0], 0xff000000u);
        for (int x = 1; x < w; ++x) d[x] = add_pixels(d[x], d[x - 1]);
        for (int y = 1; y < height; ++y) {
          uint32_t* row = d + size_t(y) * w;
          const uint32_t* modes =
              t.data.data() + size_t(y >> t.bits) * tiles_per_row;
          row[0] = add_pixels(row[0], row[-w]);  // the first column: above
          for (int x = 1; x < w; ++x) {
            const int m = int((modes[x >> t.bits] >> 8) & 0xf);
            row[x] = add_pixels(row[x], predict(m, row[x - 1], row + x - w));
          }
        }
        break;
      }
      case CROSS_COLOR: {
        const int tiles_per_row = sub_sample_size(w, t.bits);
        for (int y = 0; y < height; ++y) {
          uint32_t* row = d + size_t(y) * w;
          const uint32_t* codes =
              t.data.data() + size_t(y >> t.bits) * tiles_per_row;
          for (int x = 0; x < w; ++x) {
            const uint32_t c = codes[x >> t.bits];
            const int8_t g2r = int8_t(c & 0xff), g2b = int8_t((c >> 8) & 0xff),
                         r2b = int8_t((c >> 16) & 0xff);
            const uint32_t argb = row[x];
            const int8_t green = int8_t(argb >> 8);
            int new_red = int((argb >> 16) & 0xff);
            int new_blue = int(argb & 0xff);
            new_red += (int(g2r) * green) >> 5;
            new_red &= 0xff;
            new_blue += (int(g2b) * green) >> 5;
            new_blue += (int(r2b) * int8_t(new_red)) >> 5;
            new_blue &= 0xff;
            row[x] = (argb & 0xff00ff00u) | (uint32_t(new_red) << 16) |
                     uint32_t(new_blue);
          }
        }
        break;
      }
      case SUBTRACT_GREEN: {
        const size_t n = size_t(w) * height;
        for (size_t k = 0; k < n; ++k) {
          const uint32_t argb = d[k];
          const uint32_t green = (argb >> 8) & 0xff;
          uint32_t rb = argb & 0x00ff00ffu;
          rb += (green << 16) | green;
          d[k] = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
        }
        break;
      }
      case COLOR_INDEXING: {
        const int in_w = sub_sample_size(w, t.bits);
        std::vector<uint32_t> out(size_t(w) * height);
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        for (int y = 0; y < height; ++y) {
          const uint32_t* src = d + size_t(y) * in_w;
          uint32_t* dst = out.data() + size_t(y) * w;
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        px->swap(out);
        break;
      }
    }
  }
}

// VP8L's header size: libwebp's VP8LGetInfo.
void vp8l_info(const uint8_t* d, size_t n, int* width, int* height) {
  if (n < 5) fail("VP8L: truncated header");
  if (d[0] != 0x2f || (d[4] >> 5) != 0) fail("VP8L: bad signature");
  Vp8lDecoder(d, n).header(width, height);
}

// ------------------------------------------------------------ ALPH

// What libwebp's alpha decoder refuses (ALPHInit, then the decode): the
// header's reserved bits, a method or pre-processing it does not know, a
// raw plane shorter than the frame, a lossless stream that does not
// decode. The values themselves are dropped.
void check_alpha(const uint8_t* d, size_t n, int width, int height) {
  if (n <= 1) fail("ALPH: empty");
  const int method = d[0] & 3, pre_processing = (d[0] >> 4) & 3,
            rsrv = d[0] >> 6;
  if (method > 1 || pre_processing > 1 || rsrv != 0)
    fail("ALPH: bad header");
  if (method == 0) {
    if (n - 1 < size_t(width) * size_t(height))
      fail("ALPH: raw plane shorter than the frame");
  } else {
    Vp8lDecoder(d + 1, n - 1).decode_alpha(width, height);
  }
}

// ------------------------------------------------------- container

struct Frame {
  int x_offset = 0, y_offset = 0, width = 0, height = 0;
  int frame_num = 0;
  bool complete = false;
  // offsets and sizes of the chunks (header included, padded payload as
  // far as the file holds it)
  size_t alpha_offset = 0, alpha_size = 0, image_offset = 0, image_size = 0;
};

struct Container {
  int canvas_width = 0, canvas_height = 0;
  uint32_t flags = 0;
  bool is_ext = false;
  std::vector<Frame> frames;
};

constexpr uint32_t kAlphaFlag = 0x10, kAnimationFlag = 0x02,
                   kAllValidFlags = 0x3e;
constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;

// libwebp's demuxer on a whole file (WebPDemux, no partial data).
class Demuxer {
 public:
  Demuxer(const uint8_t* d, size_t n) : d_(d) {
    if (n < 20) fail("WebP: truncated RIFF header");
    if (!tag_is(d, "RIFF") || !tag_is(d + 8, "WEBP"))
      fail("WebP: not a RIFF WEBP file");
    const uint32_t riff_size = le32(d + 4);
    if (riff_size < 8 || riff_size > kMaxChunkPayload)
      fail("WebP: bad RIFF size");
    riff_end_ = size_t(riff_size) + 8;
    end_ = std::min(n, riff_end_);
    if (end_ < riff_end_) fail("WebP: truncated (shorter than its RIFF size)");
    start_ = 12;
  }

  Container parse() {
    if (tag_is(d_ + start_, "VP8 ") || tag_is(d_ + start_, "VP8L")) {
      parse_single_image();
    } else if (tag_is(d_ + start_, "VP8X")) {
      parse_vp8x();
    } else {
      fail("WebP: unknown first chunk");
    }
    validate();
    return c_;
  }

 private:
  size_t data_size() const { return end_ - start_; }
  bool size_invalid(size_t size) const { return size > riff_end_ - start_; }
  uint32_t read32() {
    const uint32_t v = le32(d_ + start_);
    start_ += 4;
    return v;
  }
  uint32_t read24() {
    const uint32_t v = le24(d_ + start_);
    start_ += 3;
    return v;
  }
  static void need_more() { fail("WebP: truncated chunk"); }

  void add_frame(const Frame& f) {
    if (!c_.frames.empty() && !c_.frames.back().complete)
      fail("WebP: a frame after an incomplete one");
    c_.frames.push_back(f);
  }

  // StoreFrame: the ALPH and image chunks of a frame, from start_, up to
  // the first chunk that is not one of them.
  void store_frame(int frame_num, size_t min_size, Frame* f) {
    int alpha_chunks = 0, image_chunks = 0;
    if (data_size() < 8 || data_size() < min_size) need_more();
    bool done = false;
    do {
      const size_t chunk_start = start_;
      const uint8_t* tag = d_ + start_;
      start_ += 4;
      const uint32_t payload_size = read32();
      if (payload_size > kMaxChunkPayload) fail("WebP: bad chunk size");
      const uint32_t padded = payload_size + (payload_size & 1);
      if (size_invalid(padded)) fail("WebP: chunk past the RIFF end");
      if (padded > data_size()) need_more();
      const size_t chunk_size = 8 + size_t(padded);
      const bool vp8l = tag_is(tag, "VP8L");
      if (tag_is(tag, "ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        f->alpha_offset = chunk_start;
        f->alpha_size = chunk_size;
        f->frame_num = frame_num;
        start_ += padded;
      } else if ((vp8l || tag_is(tag, "VP8 ")) && image_chunks == 0) {
        if (vp8l && alpha_chunks > 0) fail("WebP: ALPH before a VP8L image");
        int w = 0, h = 0;
        const uint8_t* payload = tag + 8;
        if (vp8l) {
          vp8l_info(payload, padded, &w, &h);
        } else {
          vp8_info(payload, padded, payload_size, &w, &h);
        }
        ++image_chunks;
        f->image_offset = chunk_start;
        f->image_size = chunk_size;
        f->width = w;
        f->height = h;
        f->frame_num = frame_num;
        f->complete = true;
        start_ += padded;
      } else {
        if (vp8l && alpha_chunks > 0) fail("WebP: ALPH before a VP8L image");
        start_ = chunk_start;  // not this frame's: left to the caller
        done = true;
      }
      if (start_ == riff_end_) {
        done = true;
      } else if (data_size() < 8) {
        need_more();
      }
    } while (!done);
  }

  void parse_single_image() {
    if (!c_.frames.empty()) fail("WebP: a second image");
    if (size_invalid(8)) fail("WebP: chunk past the RIFF end");
    if (data_size() < 8) need_more();
    Frame f;
    store_frame(1, 0, &f);
    if (!(c_.flags & kAlphaFlag))
      f.alpha_offset = f.alpha_size = 0;  // no alpha flag: ALPH ignored
    if (!c_.is_ext && f.width > 0 && f.height > 0) {
      c_.canvas_width = f.width;
      c_.canvas_height = f.height;
      check_pixels(f.width, f.height, "WebP canvas");
    }
    add_frame(f);
  }

  void parse_vp8x() {
    if (data_size() < 8) need_more();
    c_.is_ext = true;
    start_ += 4;
    uint32_t vp8x_size = read32();
    if (vp8x_size > kMaxChunkPayload || vp8x_size < 10)
      fail("WebP: bad VP8X size");
    vp8x_size += vp8x_size & 1;
    if (size_invalid(vp8x_size)) fail("WebP: chunk past the RIFF end");
    if (data_size() < vp8x_size) need_more();
    c_.flags = d_[start_];
    start_ += 4;  // flags and reserved bytes
    c_.canvas_width = int(read24()) + 1;
    c_.canvas_height = int(read24()) + 1;
    if (uint64_t(c_.canvas_width) * uint64_t(c_.canvas_height) >=
        (uint64_t(1) << 32))
      fail("WebP: canvas too large");
    check_pixels(c_.canvas_width, c_.canvas_height, "WebP canvas");
    start_ += vp8x_size - 10;
    if (size_invalid(8)) fail("WebP: chunk past the RIFF end");
    if (data_size() < 8) need_more();
    parse_vp8x_chunks();
  }

  void parse_vp8x_chunks() {
    const bool is_animation = c_.flags & kAnimationFlag;
    int anim_chunks = 0;
    for (;;) {
      const size_t chunk_start = start_;
      const uint8_t* tag = d_ + start_;
      start_ += 4;
      const uint32_t chunk_size = read32();
      if (chunk_size > kMaxChunkPayload) fail("WebP: bad chunk size");
      const uint32_t padded = chunk_size + (chunk_size & 1);
      if (size_invalid(padded)) fail("WebP: chunk past the RIFF end");
      if (tag_is(tag, "VP8X")) {
        fail("WebP: a second VP8X chunk");
      } else if (tag_is(tag, "ALPH") || tag_is(tag, "VP8 ") ||
                 tag_is(tag, "VP8L")) {
        if (anim_chunks > 0 || is_animation)
          fail("WebP: an image outside the animation's frames");
        start_ = chunk_start;
        parse_single_image();
      } else if (tag_is(tag, "ANIM")) {
        if (padded < 6) fail("WebP: bad ANIM size");
        if (data_size() < padded) need_more();
        if (anim_chunks == 0) ++anim_chunks;
        start_ += padded;
      } else if (tag_is(tag, "ANMF")) {
        if (anim_chunks == 0) fail("WebP: ANMF before ANIM");
        parse_animation_frame(padded);
      } else {  // ICCP, EXIF, XMP and unknown chunks: skipped
        if (padded > data_size()) need_more();
        start_ += padded;
      }
      if (start_ == riff_end_) break;
      if (data_size() < 8) need_more();
    }
  }

  void parse_animation_frame(uint32_t frame_chunk_size) {
    const bool is_animation = c_.flags & kAnimationFlag;
    if (size_invalid(16)) fail("WebP: chunk past the RIFF end");
    if (frame_chunk_size < 16) fail("WebP: bad ANMF size");
    if (data_size() < 16) need_more();
    const uint32_t anmf_payload_size = frame_chunk_size - 16;
    Frame f;
    f.x_offset = 2 * int(read24());
    f.y_offset = 2 * int(read24());
    f.width = 1 + int(read24());
    f.height = 1 + int(read24());
    start_ += 4;  // duration and flags
    if (uint64_t(f.width) * uint64_t(f.height) >= (uint64_t(1) << 32))
      fail("WebP: frame too large");
    const size_t frame_start = start_;
    store_frame(int(c_.frames.size()) + 1, anmf_payload_size, &f);
    if (start_ - frame_start > anmf_payload_size)
      fail("WebP: a frame's chunks past its ANMF chunk");
    if (is_animation && f.frame_num > 0) add_frame(f);
  }

  // IsValidSimpleFormat / IsValidExtendedFormat
  void validate() const {
    if (c_.canvas_width <= 0 || c_.canvas_height <= 0)
      fail("WebP: no canvas");
    if (c_.frames.empty()) fail("WebP: no image");
    if (!c_.is_ext) {
      const Frame& f = c_.frames[0];
      if (f.width <= 0 || f.height <= 0) fail("WebP: empty image");
      return;
    }
    const bool is_animation = c_.flags & kAnimationFlag;
    if (c_.flags & ~kAllValidFlags) fail("WebP: bad VP8X flags");
    for (const Frame& f : c_.frames) {
      if (!is_animation && f.frame_num > 1) fail("WebP: a second image");
      if (!f.complete) fail("WebP: a frame without its image");
      if (f.alpha_size > 0 && f.alpha_offset > f.image_offset)
        fail("WebP: ALPH after the image");
      if (f.width <= 0 || f.height <= 0) fail("WebP: empty frame");
      if (!is_animation) {
        if (f.x_offset != 0 || f.y_offset != 0 ||
            f.width != c_.canvas_width || f.height != c_.canvas_height)
          fail("WebP: the image's size (" + std::to_string(f.width) + " x " +
               std::to_string(f.height) + ") is not the canvas's (" +
               std::to_string(c_.canvas_width) + " x " +
               std::to_string(c_.canvas_height) + ")");
      } else if (int64_t(f.width) + f.x_offset > c_.canvas_width ||
                 int64_t(f.height) + f.y_offset > c_.canvas_height) {
        fail("WebP: a frame outside the canvas");
      }
    }
  }

  const uint8_t* d_;
  size_t start_ = 0, end_ = 0, riff_end_ = 0;
  Container c_;
};

// The container checked, the canvas held to the limit as soon as it is
// known.
Container parse_container(const uint8_t* data, size_t size) {
  return Demuxer(data, size).parse();
}

// The first frame's fragment as libwebp's WebPDecode parses it: optional
// ALPH (and other) chunks, then the VP8 or VP8L chunk, whose declared size
// must fit.
void decode_frame(const uint8_t* data, const Frame& f, uint8_t* rgb,
                  size_t stride) {
  const uint8_t* frag =
      data + (f.alpha_size > 0 ? f.alpha_offset : f.image_offset);
  size_t frag_size = f.image_size;
  if (f.alpha_size > 0)
    frag_size +=
        f.alpha_size + (f.image_offset - (f.alpha_offset + f.alpha_size));
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  const uint8_t* p = frag;
  size_t left = frag_size;
  if (frag_size < 12) fail("WebP: truncated frame");
  // optional chunks before the image (ParseOptionalChunks)
  if (tag_is(p, "ALPH")) {
    for (;;) {
      if (left < 8) fail("WebP: truncated frame");
      const uint32_t chunk_size = le32(p + 4);
      if (chunk_size > kMaxChunkPayload) fail("WebP: bad chunk size");
      const size_t disk = (size_t(8) + chunk_size + 1) & ~size_t(1);
      if (tag_is(p, "VP8 ") || tag_is(p, "VP8L")) break;
      if (left < disk) fail("WebP: truncated frame");
      if (tag_is(p, "ALPH")) {
        alpha = p + 8;
        alpha_size = chunk_size;
      }
      p += disk;
      left -= disk;
    }
  }
  // the image chunk (ParseVP8Header)
  if (left < 8) fail("WebP: truncated frame");
  const bool lossless = tag_is(p, "VP8L");
  const uint32_t size = le32(p + 4);
  if (size > left - 8) fail("WebP: truncated image chunk");
  const uint8_t* payload = p + 8;
  const size_t payload_left = left - 8;
  uint8_t* dst = rgb + size_t(f.y_offset) * stride + size_t(f.x_offset) * 3;
  if (!lossless) {
    if (payload_left < 10) fail("VP8: truncated frame header");
    Vp8Decoder dec(payload, payload_left, size);
    dec.decode(rgb, stride, f.x_offset, f.y_offset);
    if (alpha) check_alpha(alpha, alpha_size, dec.width(), dec.height());
  } else {
    if (payload_left < 5) fail("VP8L: truncated header");
    int w = 0, h = 0;
    Vp8lDecoder dec(payload, payload_left);
    dec.header(&w, &h);
    const std::vector<uint32_t> argb = dec.decode(w, h);
    for (int y = 0; y < h; ++y) {
      const uint32_t* src = argb.data() + size_t(y) * w;
      uint8_t* row = dst + size_t(y) * stride;
      for (int x = 0; x < w; ++x) {
        row[3 * x + 0] = uint8_t(src[x] >> 16);
        row[3 * x + 1] = uint8_t(src[x] >> 8);
        row[3 * x + 2] = uint8_t(src[x]);
      }
    }
  }
}

}  // namespace

Info info(const uint8_t* data, size_t size) {
  const Container c = parse_container(data, size);
  return Info{c.canvas_width, c.canvas_height};
}

void decode(const uint8_t* data, size_t size, uint8_t* rgb, int width,
            int height) {
  const Container c = parse_container(data, size);
  if (c.canvas_width != width || c.canvas_height != height)
    fail("WebP: the output's size is not the canvas's");
  const size_t stride = size_t(width) * 3;
  std::memset(rgb, 0, stride * size_t(height));
  decode_frame(data, c.frames[0], rgb, stride);
}

}  // namespace mmst_webp

extern "C" {

static int mmst_webp_error(const std::exception& e, char* err, int errlen) {
  if (errlen > 0) {
    std::strncpy(err, e.what(), size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
  return 1;
}

int mmst_webp_info(const uint8_t* data, size_t size, int* width, int* height,
                   char* err, int errlen) {
  try {
    const mmst_webp::Info info = mmst_webp::info(data, size);
    *width = info.width;
    *height = info.height;
    return 0;
  } catch (const std::exception& e) {
    return mmst_webp_error(e, err, errlen);
  }
}

int mmst_webp_decode(const uint8_t* data, size_t size, uint8_t* rgb,
                     int width, int height, char* err, int errlen) {
  try {
    mmst_webp::decode(data, size, rgb, width, height);
    return 0;
  } catch (const std::exception& e) {
    return mmst_webp_error(e, err, errlen);
  }
}

}  // extern "C"
