// LittleCMS 2's evaluation of an optimised 8-bit -> 8-bit transform
// (cmsxform.c's 16-bit worker on the CLUT that cmsopt.c's
// OptimizeByResampling builds), written for the port: the input
// formatter's FROM_8_TO_16, cmsintrp.c's TetrahedralInterp16 and the
// output formatter's FROM_16_TO_8, in their integer arithmetic.
// utils/cms.py computes the CLUT; this runs it over an image's pixels.

#include "cms.h"

namespace mmst_cms {

namespace {

// _cmsToFixedDomain: a 16.16 fixed-point position on the grid
inline int32_t to_fixed(int32_t a) { return a + ((a + 0x7fff) / 0xffff); }

inline uint8_t to8(int32_t w) {   // FROM_16_TO_8
  return uint8_t((uint32_t(w) * 65281u + 8388608u) >> 24);
}

}  // namespace

void tetrahedral8(const uint8_t* in, int64_t n, const uint16_t* clut,
                  int grid, uint8_t* out) {
  const int32_t domain = grid - 1;
  const int32_t opta0 = 3, opta1 = 3 * grid, opta2 = 3 * grid * grid;
  for (int64_t p = 0; p < n; ++p, in += 3, out += 3) {
    const int32_t w0 = in[0] * 257, w1 = in[1] * 257, w2 = in[2] * 257;
    const int32_t fx = to_fixed(w0 * domain), fy = to_fixed(w1 * domain),
                  fz = to_fixed(w2 * domain);
    const int32_t rx = fx & 0xffff, ry = fy & 0xffff, rz = fz & 0xffff;
    int32_t X1 = w0 == 0xffff ? 0 : opta2;
    int32_t Y1 = w1 == 0xffff ? 0 : opta1;
    int32_t Z1 = w2 == 0xffff ? 0 : opta0;
    const uint16_t* t =
        clut + (fx >> 16) * opta2 + (fy >> 16) * opta1 + (fz >> 16) * opta0;
    // the simplex of the cube that holds the point, and the three corner
    // offsets from the cube's first one, as TetrahedralInterp16 sums them
    int kind;
    if (rx >= ry) {
      if (ry >= rz) {
        Y1 += X1;
        Z1 += Y1;
        kind = 0;
      } else if (rz >= rx) {
        X1 += Z1;
        Y1 += X1;
        kind = 1;
      } else {
        Z1 += X1;
        Y1 += Z1;
        kind = 2;
      }
    } else {
      if (rx >= rz) {
        X1 += Y1;
        Z1 += X1;
        kind = 3;
      } else if (ry >= rz) {
        Z1 += Y1;
        X1 += Z1;
        kind = 4;
      } else {
        Y1 += Z1;
        X1 += Y1;
        kind = 5;
      }
    }
    for (int k = 0; k < 3; ++k) {
      int32_t c1 = t[X1 + k], c2 = t[Y1 + k], c3 = t[Z1 + k];
      const int32_t c0 = t[k];
      switch (kind) {
        case 0: c3 -= c2; c2 -= c1; c1 -= c0; break;
        case 1: c2 -= c1; c1 -= c3; c3 -= c0; break;
        case 2: c2 -= c3; c3 -= c1; c1 -= c0; break;
        case 3: c3 -= c1; c1 -= c2; c2 -= c0; break;
        case 4: c1 -= c3; c3 -= c2; c2 -= c0; break;
        default: c1 -= c2; c2 -= c3; c3 -= c0; break;
      }
      // in lcms's int32 arithmetic, wrapping where it overflows
      const int32_t rest = int32_t(uint32_t(c1) * uint32_t(rx) +
                                   uint32_t(c2) * uint32_t(ry) +
                                   uint32_t(c3) * uint32_t(rz) + 0x8001u);
      const int32_t sum = int32_t(uint32_t(rest) + uint32_t(rest >> 16));
      out[k] = to8(uint16_t(c0 + (sum >> 16)));
    }
  }
}

}  // namespace mmst_cms

extern "C" {

void mmst_cms_tetrahedral8(const uint8_t* in, int64_t n,
                           const uint16_t* clut, int grid, uint8_t* out) {
  mmst_cms::tetrahedral8(in, n, clut, grid, out);
}

}  // extern "C"
