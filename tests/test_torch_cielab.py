"""The port's CIELab -> sRGB transform (``utils/cms.py`` with the 8-bit
worker of ``native/cms.cpp``) and CIELab TIFFs against PIL (Pillow 12's
``Image.convert("RGB")`` of a ``LAB`` image, through LittleCMS) and the
JAX package on the CPU, with 0 values differing:

* sRGB's colorants as lcms builds them, against ImageCms's own profile;
* the transform on every (L, a, b) triple next to each CLUT node (the
  bytes on either side of each node's word), white, black, the corners of
  the a/b square and the grey axis, and 2^20 seeded triples more;
* every CIELab fixture of tests/data/tiff/ (chunky and planar, raw, LZW,
  PackBits and Deflate, strips and tiles, an orientation, an a/b ramp);
  a seeded sweep at odd sizes (1x1, 1x17, 17x1, 33x47); the entry points
  against the JAX package's arrays; the photometrics and layouts PIL
  refuses (ICCLab, ITULab, CIELab with extra samples or 16 bits) refused.

The comparison over all 2^24 triples was made once (CHANGES.md); the
tests here hold a quarter-million and a million of them.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image, ImageCms

from mastermetastyletransfer_tpu import serve as jserve
from mastermetastyletransfer_tpu.data import pipeline as jpipe
from mastermetastyletransfer_tpu_torch import serve as tserve
from mastermetastyletransfer_tpu_torch.data import pipeline as tpipe
from mastermetastyletransfer_tpu_torch.utils import cms
from scripts import make_image_format_fixtures as fx
from tests import torch_image_formats as tf

LAB_NAMES = [n for n in tf.names("tiff") if "cielab" in n]


def _pil_lab(triples: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB") of (n, 3) bytes of mode LAB."""
    n = len(triples)
    im = Image.frombytes("LAB", (n, 1), np.ascontiguousarray(
        triples, np.uint8).tobytes())
    return np.asarray(im.convert("RGB")).reshape(n, 3)


def _assert_same(triples: np.ndarray) -> None:
    want = _pil_lab(triples)
    got = cms.lab_to_rgb(triples)
    bad = np.nonzero((got != want).any(axis=1))[0]
    assert bad.size == 0, (len(bad), triples[bad[:5]].tolist(),
                           got[bad[:5]].tolist(), want[bad[:5]].tolist())


def test_srgb_colorants_are_lcms_profiles():
    """cmsCreate_sRGBProfile's colorants (Rec. 709 at D65, Bradford to
    D50), as ImageCms reads them from its own sRGB profile."""
    profile = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).profile
    m = cms.srgb_colorants()
    for k, colorant in enumerate((profile.red_colorant,
                                  profile.green_colorant,
                                  profile.blue_colorant)):
        assert tuple(colorant[0]) == (m[0][k], m[1][k], m[2][k]), k


def test_clut_nodes_white_black_and_corners():
    """Every triple whose bytes lie next to a CLUT node's word on each
    axis (33^3 nodes, each axis's bytes on either side of i * 65535 / 32),
    white (255, 0, 0), black, the corners of the a/b square at every L
    and the grey axis."""
    q = np.floor(np.arange(cms.GRID) * 65535.0 / (cms.GRID - 1) + 0.5)
    axis = np.unique(np.concatenate([np.floor(q / 257), np.ceil(q / 257)])
                     ).astype(np.uint8)
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                    -1).reshape(-1, 3)
    assert len(axis) >= 2 * cms.GRID - 2 and len(grid) >= 64 ** 3
    corners = [(L, a, b) for L in range(256) for a in (0x7F, 0x80)
               for b in (0x7F, 0x80)]
    grey = [(L, 0, 0) for L in range(256)]
    _assert_same(np.concatenate([grid, np.array(
        [(255, 0, 0), (0, 0, 0)] + corners + grey, np.uint8)]))


@pytest.mark.parametrize("part", range(4))
def test_seeded_triples(part):
    """2^20 seeded (L, a, b) triples in four parts."""
    rng = np.random.default_rng(1000 + part)
    _assert_same(rng.integers(0, 256, (1 << 18, 3), dtype=np.uint8))


def test_clut_is_computed_once():
    assert cms.lab_clut() is cms.lab_clut()
    assert cms.lab_clut().shape == (33, 33, 33, 3)
    assert not cms.lab_clut().flags.writeable


@pytest.mark.parametrize("name", LAB_NAMES)
def test_cielab_fixture_matches_pil(name):
    data = tf.read("tiff", name)
    want = tf.stored("tiff", name)
    pixels, fmt = tf.pil(data)
    assert fmt == "TIFF"
    got = tpipe.decode_image(data)
    if isinstance(want, tuple):   # the 640x480 timing input
        assert (pixels.shape, tf.digest(pixels)) == want
        assert (got.shape, tf.digest(got)) == want
    else:
        assert np.array_equal(pixels, want)
        assert got.shape == want.shape
        assert np.count_nonzero(got != want) == 0


def test_cielab_fixtures_cover_the_kinds():
    from mastermetastyletransfer_tpu_torch.utils import tiff as ttiff

    def tags(name):
        ifd = ttiff._Ifd(tf.read("tiff", name))
        return {t: ifd.get(t) for t in ifd.tags}
    assert len(LAB_NAMES) >= 9
    assert all(tags(n)[262] == 8 for n in LAB_NAMES)
    assert {tags(n)[259] for n in LAB_NAMES} >= {1, 5, 8, 32773}
    assert tags("cielab_planar_raw")[284] == 2
    assert 322 in tags("cielab_tiles_lzw")


@pytest.mark.parametrize("hw", tf.SIZES[:4])
def test_cielab_sweep_matches_pil(hw):
    """CIELab TIFFs at odd sizes: chunky and planar, each codec, strips of
    one row and tiles."""
    rng = np.random.default_rng(hw[0] * 13 + hw[1])
    px = rng.integers(0, 256, hw + (3,))
    for kw in ({}, {"planar": 2}, {"compression": 5, "rows_per_strip": 1},
               {"compression": 8, "planar": 2}, {"compression": 32773},
               {"compression": 50000, "tile": (16, 16)},
               {"compression": 34925, "orientation": 3}):
        tf.assert_pil_pixels(tpipe.decode_image,
                             fx.tiff_file(px, photometric=8, **kw), kw)


@pytest.mark.parametrize("photometric,kw", [
    (9, {}), (10, {}), (8, {"extra": (0,)}), (8, {"bps": 16})])
def test_lab_layouts_pil_refuses_are_refused(photometric, kw):
    """ICCLab (9) and ITULab (10), CIELab with an extra sample and 16-bit
    CIELab: Pillow has no mode for them, nor does the port."""
    rng = np.random.default_rng(photometric)
    spp = 3 + len(kw.get("extra", ()))
    data = fx.tiff_file(rng.integers(0, 256, (5, 7, spp)),
                        photometric=photometric, **kw)
    assert tf.pil(data)[0] is None
    with pytest.raises(ValueError):
        tpipe.decode_image(data)


@pytest.mark.parametrize("name", ["coco_cielab", "cielab_planar_deflate"])
def test_cielab_entry_points_match_jax(name):
    """_decode_resize and serve._decode_to equal the JAX package's."""
    path = os.path.join(tf.DATA, "tiff", f"{name}.tif")
    for size in (32, 100):
        assert np.array_equal(tpipe._decode_resize(path, size),
                              jpipe._decode_resize(path, size)), size
    data = tf.read("tiff", name)
    assert np.array_equal(tserve._decode_to(64, data),
                          jserve._decode_to(64, data))


def test_lab_image_pixels_via_frombytes():
    """Pillow's LAB bytes of an image, unpacked from a chunky CIELab TIFF
    (the file's a and b as they are) and from a planar one (its a and b
    bands turned to two's complement), give PIL's pixels."""
    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (9, 11, 3))
    for planar in (1, 2):
        data = fx.tiff_file(px, photometric=8, planar=planar)
        with Image.open(io.BytesIO(data)) as im:
            lab = np.asarray(im)
            want = np.asarray(im.convert("RGB"))
        assert np.array_equal(cms.lab_to_rgb(lab[..., :3]), want)
        assert np.array_equal(tpipe.decode_image(data), want)
