"""The port's CIELab -> sRGB transform: Pillow's ``Image.convert("RGB")``
of a ``LAB`` image, computed without LittleCMS (the machine with the card
has neither PIL nor lcms2).

Pillow 12 converts LAB to RGB with ``ImageCms.buildTransform(
createProfile("LAB"), createProfile("sRGB"), "LAB", "RGB")``: LittleCMS
2's ``cmsCreateLab2Profile(NULL)`` (a V2 abstract profile, Lab on both
sides, an identity A2B0) and ``cmsCreate_sRGBProfile()`` (a V4 matrix-
shaper), the perceptual intent, no flags, 8-bit Lab in (its a and b taken
as Pillow's two's complement, turned to lcms's offset 128) and 8-bit RGB
out. What lcms2 2.17 builds from that, and what this module computes:

* the pipeline, as ``_cmsLinkProfiles`` and ``PreOptimize`` leave it: the
  Lab profile's V4 -> V2 and V2 -> V4 matrices cancel and its identity
  curves go, no black-point compensation applies (the Lab profile's black
  point is 0, as is sRGB's), so it is Lab -> XYZ (``cmsLab2XYZ`` at D50,
  the XYZ encoded over 1 + 32767/32768), the inverse of sRGB's colorant
  matrix times that encoding, and the inverse of sRGB's parametric curve
  (type -4 of 2.4, 1/1.055, 0.055/1.055, 1/12.92, 0.04045); each stage
  in double on float32 inputs, its outputs float32, as
  ``cmsPipelineEvalFloat`` runs them;
* sRGB's colorants as ``cmsCreateRGBProfile`` computes them: Rec. 709's
  primaries and D65 (``_cmsBuildRGB2XYZtransferMatrix``) adapted to D50
  by Bradford (``_cmsAdaptationMatrix``), in lcms's own order of double
  operations (``_cmsMAT3inverse``, ``_cmsMAT3per``);
* ``OptimizeByResampling`` for an 8-bit transform: a CLUT of 33 nodes a
  side (``_cmsReasonableGridpointsByColorspace`` for 3 channels), each
  node's words ``floor(i * 65535 / 32 + 0.5)`` read as float32 ``w /
  65535``, its outputs times 65535 to words by ``_cmsQuickSaturateWord``
  (lcms's fast floor: the value rounded to 2^-16, then floored); no pre-
  or post-linearisation (8 bits on either side); the white fix-up leaves
  the table as it is, Lab's white (0xFFFF, 0x8080, 0x8080) lying on no
  node;
* the 8-bit worker (``native/cms.cpp``): each byte the word b * 257,
  ``TetrahedralInterp16`` on the CLUT, ``FROM_16_TO_8``.

The table is computed at first use and kept; nothing of lcms's or PIL's
outputs is stored. The tests hold the result to PIL's on every CLUT node,
white, black, the corners of the a/b square and 2^20 triples more; it
was checked once on all 2^24 (CHANGES.md).
"""

from __future__ import annotations

import functools
import math

import numpy as np

# cmsD50_XYZ, and MAX_ENCODEABLE_XYZ (1.15 fixed point's largest value)
_D50 = (0.9642, 1.0, 0.8249)
_MAX_XYZ = 1.0 + 32767.0 / 32768.0
# cmsCreate_sRGBProfile: D65 and Rec. 709's primaries (xy), and the
# parametric curve of type 4 (sRGB)
_D65 = (0.3127, 0.3290)
_PRIMARIES = ((0.6400, 0.3300), (0.3000, 0.6000), (0.1500, 0.0600))
_CURVE = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)
_BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367),
             (0.0389, -0.0685, 1.0296))
GRID = 33


def _inverse(a):
    """_cmsMAT3inverse, in its order of operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return ((c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det),
            (c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det),
            (c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det))


def _product(a, b):
    """_cmsMAT3per: a times b."""
    return tuple(tuple(a[i][0] * b[0][j] + a[i][1] * b[1][j]
                       + a[i][2] * b[2][j] for j in range(3))
                 for i in range(3))


def _apply(a, v):
    """_cmsMAT3eval: a times the vector v."""
    return tuple(a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
                 for i in range(3))


def _bradford(src, dst):
    """_cmsAdaptationMatrix (ComputeChromaticAdaptation) from white src to
    white dst, both XYZ."""
    s, d = _apply(_BRADFORD, src), _apply(_BRADFORD, dst)
    cone = ((d[0] / s[0], 0.0, 0.0), (0.0, d[1] / s[1], 0.0),
            (0.0, 0.0, d[2] / s[2]))
    return _product(_inverse(_BRADFORD), _product(cone, _BRADFORD))


def srgb_colorants():
    """cmsCreateRGBProfile's colorant matrix of sRGB (columns the red,
    green and blue colorants' XYZ at D50)."""
    xn, yn = _D65
    (xr, yr), (xg, yg), (xb, yb) = _PRIMARIES
    coef = _apply(_inverse(((xr, xg, xb), (yr, yg, yb),
                            ((1 - xr - yr), (1 - xg - yg), (1 - xb - yb)))),
                  (xn / yn, 1.0, (1.0 - xn - yn) / yn))
    rgb2xyz = ((coef[0] * xr, coef[1] * xg, coef[2] * xb),
               (coef[0] * yr, coef[1] * yg, coef[2] * yb),
               (coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
                coef[2] * (1.0 - xb - yb)))
    white = ((xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0)  # cmsxyY2XYZ
    return _product(_bradford(white, _D50), rgb2xyz)


def _lab_to_xyz(t: np.ndarray) -> np.ndarray:
    """cmsLab2XYZ's f^-1."""
    return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0),
                    t * t * t)


def pipeline(inp: np.ndarray) -> np.ndarray:
    """cmsPipelineEvalFloat of the linked pipeline on float32 (n, 3)
    inputs in lcms's V4 Lab encoding (0..1): float32 (n, 3) sRGB, not
    clipped."""
    v = inp.astype(np.float64)
    y = (v[:, 0] * 100.0 + 16.0) / 116.0   # EvaluateLab2XYZ
    x = y + 0.002 * (v[:, 1] * 255.0 - 128.0)
    z = y - 0.005 * (v[:, 2] * 255.0 - 128.0)
    xyz = np.stack([_lab_to_xyz(c) * w / _MAX_XYZ
                    for c, w in zip((x, y, z), _D50)], -1).astype(np.float32)
    m = [[e * _MAX_XYZ for e in row] for row in _inverse(srgb_colorants())]
    xyz = xyz.astype(np.float64)
    lin = np.stack([xyz[:, 0] * r[0] + xyz[:, 1] * r[1] + xyz[:, 2] * r[2]
                    for r in m], -1).astype(np.float32).astype(np.float64)
    g, a, b, c, d = _CURVE   # the inverse of type 4 (lcms's type -4)
    # pow as the C library computes it (numpy's may take other SIMD
    # routines, off by an ulp)
    root = np.array([math.pow(r, 1.0 / g) if r > 0 else 0.0
                     for r in lin.reshape(-1).tolist()]).reshape(lin.shape)
    return np.where(lin >= math.pow(a * d + b, g), (root - b) / a,
                    lin / c).astype(np.float32)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord with lcms's fast floor (the value plus 0.5
    rounded to a multiple of 2^-16 before it is floored)."""
    d = d + 0.5
    floor = np.floor(np.rint((d - 32767.0) * 65536.0) / 65536.0) + 32767.0
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor)).astype(
        np.uint16)


@functools.lru_cache(maxsize=1)
def lab_clut() -> np.ndarray:
    """OptimizeByResampling's CLUT of the LAB -> sRGB transform:
    (33, 33, 33, 3) uint16, L the slowest index, then a, then b."""
    q = np.floor(np.arange(GRID) * 65535.0 / (GRID - 1) + 0.5)
    nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(-1, 3)
    out = pipeline((nodes / 65535.0).astype(np.float32))
    table = _saturate_word(out.astype(np.float64) * 65535.0)
    table.flags.writeable = False
    return table.reshape(GRID, GRID, GRID, 3)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """Pillow's convert("RGB") of a LAB image: (..., 3) uint8 of Pillow's
    LAB bytes (L, then a and b in two's complement) -> (..., 3) uint8."""
    from mastermetastyletransfer_tpu_torch.data import native_loader

    src = np.asarray(lab, np.uint8) ^ np.array([0, 128, 128], np.uint8)
    return native_loader.cms_tetrahedral8(src, lab_clut())
