"""The data pipeline: COCO content and WikiArt style streams (JAX
counterpart: data/pipeline.py; reference: codes/get_dataloader.py,
train.py:222-245, :411-416).

The host half decodes each image and resizes it to the fixed staging size
(``resize_to``): ``list_images`` finds the files, ``InfiniteIndexSampler``
draws an endless reshuffled index stream, ``ImageFolderDataset`` decodes
(batches through the native JPEG loader where it builds,
data/native_loader.py), and ``PrefetchLoader`` prefetches batches from
worker threads in a deterministic order. The device half turns a staged
uint8 batch into float crops in [0, 1] on its device and repeats one style
image to the content batch; ``device_preprocess_pair`` makes a training
step's two inputs so, by the configuration, as the JAX trainer does.

No PIL (the machine with the card has none): ``decode_image`` reads
what PIL's ``Image.open`` opens with the plugins it tries first (BMP,
DIB, GIF, JPEG, PPM, PNG) and four of the rest (ICO, TIFF, TGA, WebP),
trying Pillow's plugins in its order as ``Image.open`` does (the port's
kinds by their plugins' ``_accept`` and ``_open``, the others by
``utils/plugins.takes``), and reads each bit for bit as
``convert("RGB")`` gives it (``READ_FORMATS``): BMP and DIB with
``utils/bmp``, PNG with ``utils/png.read_png``, Netpbm with
``utils/pnm.read_pnm``, ICO with ``utils/ico.read_ico``, TIFF with
``utils/tiff.read_tiff``, TGA with ``utils/tga.read_tga``, JPEG, GIF and
WebP with the port's own decoders (``native_loader.decode_jpeg`` at full
size as PIL decodes, ``decode_gif`` and ``decode_webp`` the first frame
on its canvas); and ``_resize_bilinear`` computes Pillow's BILINEAR
resample bit for bit. A file none of them reads (PCX, a CIELab TIFF, a
12-bit JPEG, ...) raises ``ValueError`` naming it and the formats that
are read. The
batch loader (``native_loader.decode_resize_batch``) takes the JAX package's
loader's route for each JPEG: prescaled in the DCT domain as its libjpeg
does, or, for the kinds that libjpeg does not decode to RGB (CMYK, YCCK,
lossless), the full-size decode and Pillow's BILINEAR.

Under data parallelism (a ``DataShard``: rank r of n, ``grad_accum_steps``
a) every rank keeps the one-device run's seed and index stream, so that
the ranks agree on every global batch's index group, and decodes only its
rows of each group (``DataShard.rows``); the crops are drawn for the
global batch and kept at those rows, and the styles, one image repeated,
are loaded whole on every rank and repeated to its rows. The ranks' rows,
put together in rank order (micro-batch by micro-batch under a > 1), are
the one-device run's batch.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from mastermetastyletransfer_tpu_torch.config import (
    DataConfig, ExperimentConfig,
)
from mastermetastyletransfer_tpu_torch.data.native_loader import (
    decode_gif, decode_jpeg, decode_webp,
)
from mastermetastyletransfer_tpu_torch.parallel.mesh import DataShard
from mastermetastyletransfer_tpu_torch.utils.bmp import (
    dib_accept, read_bmp, read_dib,
)
from mastermetastyletransfer_tpu_torch.utils.ico import MAGIC as ICO_MAGIC
from mastermetastyletransfer_tpu_torch.utils.ico import read_ico
from mastermetastyletransfer_tpu_torch.utils.plugins import takes
from mastermetastyletransfer_tpu_torch.utils.png import OpenRefusal, read_png
from mastermetastyletransfer_tpu_torch.utils.pnm import accept as pnm_accept
from mastermetastyletransfer_tpu_torch.utils.pnm import read_pnm
from mastermetastyletransfer_tpu_torch.utils.tiff import accept as tiff_accept
from mastermetastyletransfer_tpu_torch.utils.tga import read_tga
from mastermetastyletransfer_tpu_torch.utils.tiff import read_tiff

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
# Pillow's fixed-point precision for 8-bit resampling (libImaging/Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def list_images(root: str, recursive: bool = True) -> List[str]:
    """All image files under root, sorted (reference: a flat *.jpg glob for
    COCO, a recursive one for WikiArt, get_dataloader.py:30,81)."""
    pat = (os.path.join(root, "**", "*") if recursive
           else os.path.join(root, "*"))
    files = [f for f in glob.glob(pat, recursive=recursive)
             if f.lower().endswith(_EXTS)]
    files.sort()
    return files


class InfiniteIndexSampler:
    """Endless reshuffled index stream (reference: get_dataloader.py:10-19):
    one ``np.random.default_rng(seed).permutation(n)`` per epoch."""

    def __init__(self, n: int, seed: int = 0):
        if n <= 0:
            raise ValueError("empty dataset")
        self.n = n
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        while True:
            for i in self._rng.permutation(self.n):
                yield int(i)


def _resample_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's BILINEAR taps along one axis (libImaging/Resample.c,
    precompute_coeffs and normalize_coeffs_8bpp): for each output i, the
    (n_out, ksize) input indices and 22-bit fixed-point weights of a
    triangle filter of support max(n_in / n_out, 1) centred at
    (i + 0.5) n_in / n_out, the taps from int(centre - support + 0.5) to
    int(centre + support + 0.5) clipped to the input, the weights
    normalised to sum to one in double precision (summed in tap order),
    then rounded half away from zero. Unused taps have weight 0 and index
    0."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      n_in).astype(np.int64) - xmin
    j = np.arange(ksize)
    used = j[None, :] < xmax[:, None]
    arg = np.abs(((j[None, :] + xmin[:, None]).astype(np.float64)
                  - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(used, np.where(arg < 1.0, 1.0 - arg, 0.0), 0.0)
    total = np.zeros(n_out)
    for t in range(ksize):          # in tap order, as the C loop sums
        total += w[:, t]
    w = np.where(total[:, None] != 0.0,
                 w / np.where(total == 0.0, 1.0, total)[:, None], w)
    w = w * (1 << _PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, w - 0.5, w + 0.5)).astype(np.int64)
    idx = np.where(used, j[None, :] + xmin[:, None], 0)
    return idx, np.where(used, fixed, 0)


def _resample_rows(x: np.ndarray, n_out: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along the rows of a contiguous
    uint8 (n_in, M) array: each output row's taps gathered as whole rows
    and weighted, tap by tap, in exact int32 arithmetic (the weights are
    non-negative and sum to about 2^22, so no partial sum reaches 2^31),
    plus one half, shifted down by the precision and clipped to
    [0, 255]."""
    idx, w = _resample_taps(x.shape[0], n_out)
    x = x.astype(np.int32)
    w = w.astype(np.int32)
    acc = np.full((n_out, x.shape[1]), 1 << (_PRECISION_BITS - 1), np.int32)
    tap = np.empty_like(acc)
    for t in range(idx.shape[1]):
        np.multiply(x[idx[:, t]], w[:, t, None], out=tap)
        acc += tap
    acc >>= _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def _resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W, C) -> (size, size, C), equal bit for bit to Pillow's
    ``Image.resize((size, size), Image.BILINEAR)`` of the RGB image: a
    horizontal pass, then a vertical one, each skipped where its side
    keeps its size."""
    h, w, c = img.shape
    if w != size:
        cols = np.ascontiguousarray(img.transpose(1, 0, 2)).reshape(w, h * c)
        img = _resample_rows(cols, size).reshape(size, h, c).transpose(1, 0, 2)
    if h != size:
        rows = np.ascontiguousarray(img).reshape(h, size * c)
        img = _resample_rows(rows, size).reshape(size, size, c)
    return np.ascontiguousarray(img)


READ_FORMATS = (
    "BMP (1-, 4- and 8-bit palettes, RLE8, RLE4, 16-, 24- and 32-bit, bit "
    "fields, core to V5 headers)",
    "DIB (a BMP without its file header)",
    "GIF (the first frame on its canvas)",
    "baseline JPEG", "progressive JPEG", "arithmetic-coded JPEG",
    "lossless JPEG", "CMYK and YCCK JPEG",
    "PBM, PGM, PPM and PFM (plain and raw, any maxval)",
    "PNG (grey, RGB, palette, grey + alpha, RGBA at 1 to 16 bits, Adam7)",
    "ICO (its largest image, PNG or BMP)",
    "TIFF (IFD 0: uncompressed, LZW, PackBits, Deflate, JPEG, CCITT "
    "Modified Huffman, RLE-W, T.4 and T.6, LZMA or Zstandard; strips or "
    "tiles; 1 to 32 bits; YCbCr at any subsampling)",
    "TGA (colour-mapped, grey and true colour, raw and run-length)",
    "WebP (lossy, lossless, alpha, animation's first frame)")

# Pillow's plugins in the order its Image.open tries them (the order they
# register in: BMP, DIB, GIF, JPEG, PPM and PNG by Image.preinit, the rest
# by Image.init), each with its _accept on the file's first bytes. The
# port's kinds read (a refusal of theirs that Pillow's _open raises as one
# of the exceptions it passes over is an OpenRefusal, and the next plugin
# is tried); a plugin the port does not read (a reader of None) ends the
# search where Pillow's would (utils/plugins.takes), and the bytes are
# refused by its name.
_KINDS = (
    ("BMP", lambda d: d[:2] == b"BM", read_bmp),
    ("DIB", dib_accept, read_dib),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a"), decode_gif),
    ("JPEG", lambda d: d[:3] == b"\xff\xd8\xff", decode_jpeg),
    ("PPM", pnm_accept, read_pnm),
    ("PNG", lambda d: d[:8] == b"\x89PNG\r\n\x1a\n", read_png),
    ("ICO", lambda d: d[:4] == ICO_MAGIC, read_ico),
    ("TIFF", tiff_accept, read_tiff),
    ("TGA", lambda d: True, read_tga),
    ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP"
     and d[12:16] in (b"VP8 ", b"VP8X", b"VP8L"), decode_webp),
)
_ORDER = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF", "BLP", "BUFR",
          "CUR", "PCX", "DCX", "DDS", "EPS", "FITS", "FLI", "FTEX", "GBR",
          "GRIB", "HDF5", "JPEG2000", "ICNS", "ICO", "IM", "IMT", "IPTC",
          "MCIDAS", "MPEG", "TIFF", "MSP", "PCD", "PIXAR", "PSD", "QOI",
          "SGI", "SPIDER", "SUN", "TGA", "WEBP", "WMF", "XBM", "XPM",
          "XVTHUMB")
_READERS = {name: (accept, read) for name, accept, read in _KINDS}


def decode_image(data: bytes) -> np.ndarray:
    """An image file's bytes as uint8 (H, W, 3) RGB, as PIL's
    ``Image.open(...).convert("RGB")`` gives them: Pillow's plugins tried
    in its order, each that accepts the first bytes opening them, the
    first that opens them reading them; ``ValueError`` for bytes no
    plugin opens, a plugin the port does not read, or a file its reader
    refuses."""
    prefix = data[:16]
    first = None
    for name in _ORDER:
        if name not in _READERS:
            if takes(name, data):
                raise ValueError(
                    f"{name}: a kind this does not read (Pillow opens it "
                    f"with its {name} plugin; read: "
                    + ", ".join(READ_FORMATS) + ")")
            continue
        accept, read = _READERS[name]
        if not accept(prefix):
            continue
        try:
            return read(data)
        except OpenRefusal as e:   # Pillow goes on to its next plugin
            first = first or e
    if first is not None:
        raise ValueError(f"{first} (and no other kind opens it)")
    raise ValueError("not an image this reads (read: "
                     + ", ".join(READ_FORMATS) + ")")


def _decode_resize(path: str, resize_to: int) -> np.ndarray:
    """Host side: decode -> RGB -> bilinear resize to (resize_to, resize_to)
    uint8 HWC (reference: cv2 BGR->RGB + transforms.Resize((512, 512)),
    get_dataloader.py:63-69), as the JAX package's PIL route computes it,
    without PIL. A file ``decode_image`` does not read raises ValueError
    naming it."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        pixels = decode_image(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
    return _resize_bilinear(pixels, resize_to)


class ImageFolderDataset:
    """Decoded and staged images of a directory. Batches go through the
    native loader (threaded JPEG decode + resize, native/loader.cpp) where
    it is available, with ``_decode_resize`` for every file that is not a
    JPEG it read."""

    def __init__(self, root: str, resize_to: int = 512, recursive: bool = True,
                 use_native: bool = True):
        self.files = list_images(root, recursive=recursive)
        self.resize_to = resize_to
        self.use_native = use_native

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> np.ndarray:
        return _decode_resize(self.files[i], self.resize_to)

    def get_batch(self, indices) -> np.ndarray:
        if self.use_native:
            from mastermetastyletransfer_tpu_torch.data.native_loader import (
                decode_resize_batch, native_available,
            )
            if native_available():
                return decode_resize_batch(
                    [self.files[i] for i in indices], self.resize_to)
        return np.stack([self[i] for i in indices])


class _LoadError:
    """A worker's batch failure, delivered in sequence to the consumer."""

    def __init__(self, indices, error):
        self.indices = indices
        self.error = error


class PrefetchLoader:
    """Thread-pool batch loader with a bounded prefetch window and a
    deterministic batch order.

    Yields uint8 (B, resize_to, resize_to, 3) batches forever. One index
    producer gives every batch's index group a sequence number (so batch
    n always holds the same images for a given seed), the workers decode
    concurrently, and delivery reorders by sequence number: a run with a
    fixed seed sees the same batch stream whatever the worker count or the
    threads' scheduling. The producer is gated on consumption, so that at
    most prefetch + num_workers batches are in flight while the consumer
    stalls. A worker's failure is raised at the consumer, naming the
    batch's indices. With a ``shard`` each group stays ``batch_size``
    indices of the one stream, and the batch is the shard's rows of it
    (``DataShard.rows``), the only images decoded.
    """

    def __init__(self, dataset, batch_size: int, *, num_workers: int = 4,
                 seed: int = 0, prefetch: int = 4,
                 shard: Optional[DataShard] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self._rows = (None if shard is None
                      else [int(i) for i in shard.rows(batch_size)])
        self._sampler = iter(InfiniteIndexSampler(len(dataset), seed))
        self._window = prefetch + max(1, num_workers)
        self._tasks: "queue.Queue[Tuple[int, List[int]]]" = queue.Queue(
            maxsize=prefetch)
        self._results = {}
        self._cond = threading.Condition()
        self._next_seq = 0
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(max(1, num_workers))
        ]
        self._threads.append(
            threading.Thread(target=self._produce, daemon=True))
        for t in self._threads:
            t.start()

    def _produce(self):
        seq = 0
        while not self._stop.is_set():
            # Gated on consumption, not only on the task queue: otherwise
            # the workers drain tasks into _results as fast as they decode
            # and the producer refills, so decoded but unconsumed batches
            # (and the decode threads' CPU time) grow without bound while
            # the consumer stalls.
            with self._cond:
                while (not self._stop.is_set()
                       and seq >= self._next_seq + self._window):
                    self._cond.wait(0.5)
            if self._stop.is_set():
                break
            idx = [next(self._sampler) for _ in range(self.batch_size)]
            if self._rows is not None:
                idx = [idx[i] for i in self._rows]
            while not self._stop.is_set():
                try:
                    self._tasks.put((seq, idx), timeout=0.5)
                    seq += 1
                    break
                except queue.Full:
                    continue

    def _worker(self):
        while not self._stop.is_set():
            try:
                seq, idx = self._tasks.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                if hasattr(self.dataset, "get_batch"):
                    batch = self.dataset.get_batch(idx)
                else:
                    batch = np.stack([self.dataset[i] for i in idx])
            except Exception as e:  # noqa: BLE001
                # Delivered for this sequence number instead of ending the
                # worker: a dead worker would leave a hole in the sequence
                # and __next__ would wait on it forever.
                batch = _LoadError(idx, e)
            with self._cond:
                self._results[seq] = batch
                self._cond.notify_all()

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        with self._cond:
            while self._next_seq not in self._results:
                if self._stop.is_set():
                    raise StopIteration
                self._cond.wait(0.5)
            batch = self._results.pop(self._next_seq)
            self._next_seq += 1
            self._cond.notify_all()  # wake the gated producer
        if isinstance(batch, _LoadError):
            raise RuntimeError(
                f"batch load failed for dataset indices {batch.indices}"
            ) from batch.error
        return batch

    def close(self):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()


def make_train_iterators(cfg: DataConfig, shard: Optional[DataShard] = None
                         ) -> Tuple[PrefetchLoader, PrefetchLoader]:
    """(content_loader, style_loader) over the COCO and WikiArt folders:
    the contents flat, the styles recursive; batch sizes, workers (half for
    the styles) and seeds (the styles' one more) as the JAX package's. A
    ``shard`` cuts the contents to its rows; the styles stay whole."""
    content = ImageFolderDataset(cfg.content_dir, cfg.resize_to,
                                 recursive=False)
    style = ImageFolderDataset(cfg.style_dir, cfg.resize_to, recursive=True)
    if len(content) == 0:
        raise FileNotFoundError(f"no images under {cfg.content_dir}")
    if len(style) == 0:
        raise FileNotFoundError(f"no images under {cfg.style_dir}")
    c_loader = PrefetchLoader(content, cfg.batch_size_content,
                              num_workers=cfg.num_workers, seed=cfg.seed,
                              shard=shard)
    s_loader = PrefetchLoader(style, cfg.batch_size_style,
                              num_workers=max(1, cfg.num_workers // 2),
                              seed=cfg.seed + 1)
    return c_loader, s_loader


def device_preprocess_batch(batch_u8: torch.Tensor, crop_to: int, *,
                            random_crop: bool,
                            generator: Optional[torch.Generator] = None,
                            shard: Optional[DataShard] = None,
                            groups: int = 1) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, crop_to, crop_to, C) float32 in [0, 1],
    on the batch's device: RandomCrop or CenterCrop(crop_to) + ToTensor
    (reference: train.py:222-245). A random crop draws each image's row
    offsets, then its column offsets, in [0, H - crop_to] and
    [0, W - crop_to] from ``generator`` (on the generator's device); the
    centre crop starts at ((H - crop_to) // 2, (W - crop_to) // 2). ImageNet
    normalization comes later, by the flags (train/step.py). With a
    ``shard`` the batch is its rows of ``groups`` global batches one after
    another (the meta step's inner batches), and the offsets are drawn for
    the global batches and kept at those rows."""
    b, h, w, _ = batch_u8.shape
    x = batch_u8.to(torch.float32) / 255.0
    if crop_to > h or crop_to > w:
        raise ValueError(f"crop {crop_to} larger than staged size {h}x{w}")
    if crop_to == h and crop_to == w:
        return x
    if random_crop:
        if generator is None:
            raise ValueError("random_crop requires a generator")
        rows = slice(None)
        total = b
        if shard is not None:
            per = b // groups * shard.n         # one global batch
            rows = torch.from_numpy(np.concatenate(
                [g * per + shard.rows(per) for g in range(groups)]))
            total = groups * per
        oy, ox = (torch.randint(0, n - crop_to + 1, (total,),
                                generator=generator,
                                device=generator.device)[rows].to(x.device)
                  for n in (h, w))
    else:
        oy = torch.full((b,), (h - crop_to) // 2, device=x.device)
        ox = torch.full((b,), (w - crop_to) // 2, device=x.device)
    span = torch.arange(crop_to, device=x.device)
    rows = (oy[:, None] + span)[:, :, None]
    cols = (ox[:, None] + span)[:, None, :]
    return x[torch.arange(b, device=x.device)[:, None, None], rows, cols]


def repeat_style_to_batch(style_one, batch_size: int) -> torch.Tensor:
    """One style image ((H, W, C) or (1, H, W, C), numpy or a tensor) ->
    repeated to the content batch size (reference: train.py:411-416)."""
    style_one = torch.as_tensor(style_one)
    if style_one.ndim == 3:
        style_one = style_one[None]
    return style_one[:1].repeat(batch_size, 1, 1, 1)


def device_preprocess_pair(cfg: ExperimentConfig, content_u8: torch.Tensor,
                           style_u8: torch.Tensor, *,
                           generator: Optional[torch.Generator] = None,
                           shard: Optional[DataShard] = None,
                           groups: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A training step's (content, style) from staged uint8 batches, as the
    JAX trainer makes them (its train/trainer.py:174-186): both cropped to
    ``cfg.data.crop_to``, at random per image when
    ``cfg.data.use_random_crop``, but the styles always centred in fast
    adaptation (reference: train_only_inner_loop.py:280-286); the first
    style repeated to ``cfg.data.batch_size_content``. Random crops draw
    the contents' offsets, then the styles', from ``generator``. With a
    ``shard`` the contents are its rows of ``groups`` global batches
    (``device_preprocess_batch``), the styles the whole style batch, and
    the first style is repeated to the shard's rows of one batch."""
    data = cfg.data
    content = device_preprocess_batch(content_u8, data.crop_to,
                                      random_crop=data.use_random_crop,
                                      generator=generator, shard=shard,
                                      groups=groups)
    style = device_preprocess_batch(
        style_u8, data.crop_to, generator=generator,
        random_crop=data.use_random_crop
        and cfg.train.mode != "fast_adaptation")
    b = data.batch_size_content
    return content, repeat_style_to_batch(
        style, b if shard is None else len(shard.rows(b)))
