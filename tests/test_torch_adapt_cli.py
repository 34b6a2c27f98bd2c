"""The port's few-shot adaptation command line (``adapt.main``) on the CPU:
one BMP style and 4 BMP contents at 64^2, 2 steps of batch 2, the kernels
on (their plain versions), a .npz checkpoint and VGG19 .npz.

``adapted.npz`` equals ``adapt_to_style`` called on the same inputs, bit
for bit (``adapt_to_style`` is held to JAX's by tests/test_torch_adapt.py);
only the style transformer's encoder leaves differ from the checkpoint;
each content's ``{stem}_stylized.jpg`` is ``inference.stylize``'s output
quantised, in the bytes PIL writes at quality 95 (JAX's adapt.main). JAX's ``adapt.main`` is not run: it fixes the full default
configuration and its own weights and k draws, and one 2-step call of it
took 47 s on the CPU, four times this whole file.
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mastermetastyletransfer_tpu_torch import adapt as tadapt
from mastermetastyletransfer_tpu_torch.config import ExperimentConfig
from mastermetastyletransfer_tpu_torch.data.pipeline import _decode_resize
from mastermetastyletransfer_tpu_torch.inference import stylize
from mastermetastyletransfer_tpu_torch.losses.vgg import init_vgg19_features
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.utils import checkpoint as tckpt
from tests.torch_threads import two_torch_threads  # noqa: F401

SIZE, STEPS, BATCH = 64, 2, 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("adapt")
    rng = np.random.default_rng(0)
    style = str(root / "style.bmp")
    Image.fromarray(rng.integers(0, 256, (90, 70, 3), np.uint8)).save(style)
    cdir = root / "contents"
    cdir.mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (60 + 8 * i, 80, 3),
                                     np.uint8)).save(cdir / f"photo{i}.bmp")
    cfg = ExperimentConfig()
    cfg = cfg.replace(model=cfg.model.with_kernels())
    params = init_master_model(cfg.model, torch.Generator().manual_seed(3),
                               device="cpu")
    vgg = init_vgg19_features(torch.Generator().manual_seed(4), device="cpu")
    ckpt, vgg_npz = str(root / "model.npz"), str(root / "vgg.npz")
    tckpt.save_params_npz(ckpt, params)
    tckpt.save_params_npz(vgg_npz, vgg)
    out_dir = root / "out"
    tadapt.main(["--style", style, "--content_dir", str(cdir),
                 "--checkpoint", ckpt, "--vgg_weights", vgg_npz,
                 "--out_dir", str(out_dir), "--steps", str(STEPS),
                 "--batch", str(BATCH), "--image_size", str(SIZE),
                 "--use_pallas", "--device", "cpu"])
    style_img = _decode_resize(style, SIZE).astype(np.float32) / 255.0
    files = sorted(cdir.iterdir())
    contents = np.stack([_decode_resize(str(f), SIZE).astype(np.float32)
                         / 255.0 for f in files])
    direct = tadapt.adapt_to_style(params, vgg, cfg, style_img, contents,
                                   steps=STEPS, lr=1e-4, batch=BATCH, seed=0,
                                   log=lambda s: None, device="cpu")
    return dict(out=out_dir, params=params, direct=direct, cfg=cfg,
                style=style_img, contents=contents, files=files)


def test_adapted_npz_is_adapt_to_style(run):
    want = tckpt.flatten_params(run["direct"])
    with np.load(run["out"] / "adapted.npz") as data:
        assert set(data.files) == set(want)
        for key, v in want.items():
            assert np.array_equal(data[key], v.numpy()), key


def test_only_the_style_encoder_moves(run):
    before = tckpt.flatten_params(run["params"])
    with np.load(run["out"] / "adapted.npz") as data:
        moved = [k for k in data.files
                 if not np.array_equal(data[k], before[k].numpy())]
    assert moved and all(k.startswith("style_transformer/encoder/")
                         for k in moved)


def test_one_stylized_png_per_content(run):
    """One {stem}_stylized.jpg per content (the name kept from when the
    port wrote PNG)."""
    names = sorted(f for f in os.listdir(run["out"]) if f.endswith(".jpg"))
    assert names == [f"photo{i}_stylized.jpg" for i in range(4)]
    style_b = torch.from_numpy(run["style"])[None]
    for f, c in zip(run["files"], run["contents"]):
        out = stylize(run["direct"], torch.from_numpy(c)[None], style_b,
                      run["cfg"].model, k=1, device="cpu")[0].numpy()
        buf = io.BytesIO()
        Image.fromarray(np.clip(out * 255, 0, 255).astype(np.uint8)).save(
            buf, "JPEG", quality=95)
        data = (run["out"] / f"{f.stem}_stylized.jpg").read_bytes()
        assert data == buf.getvalue(), f.name


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tadapt.main(["--style", "s.bmp", "--content_dir", str(tmp_path)])
