"""The port and chip_smoke.py stand alone: they import neither JAX nor the
JAX package nor PIL, nor Orbax, tensorstore, flax or optax (the machine
with the card has none of them)."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# What the ranks of the spatial and data-parallel tests import
# (parallel/launch.py).
WORKERS = ("torch_parallel_workers.py", "torch_dp_workers.py")

_PROBE = r"""
import importlib.abc, sys

BLOCKED = {"jax", "jaxlib", "mastermetastyletransfer_tpu", "PIL", "orbax",
           "tensorstore", "flax", "optax"}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"refused import of {name}")
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, Refuse())
import mastermetastyletransfer_tpu_torch
import mastermetastyletransfer_tpu_torch.serve
import mastermetastyletransfer_tpu_torch.inference
import mastermetastyletransfer_tpu_torch.models
import chip_smoke
print("isolated-ok")
"""


def test_port_and_smoke_import_without_jax_or_pil():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("isolated-ok")


def test_sources_name_no_jax():
    files = sorted((ROOT / "mastermetastyletransfer_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"] + [ROOT / "tests" / w for w in WORKERS]
    jax_import = re.compile(r"\bimport jax|\bfrom jax\b")
    jax_package = re.compile(r"\bmastermetastyletransfer_tpu\b(?!_torch)")
    for f in files:
        text = f.read_text()
        assert not jax_import.search(text), f
        assert not jax_package.search(text), f
    assert "PIL" not in (ROOT / "chip_smoke.py").read_text()


def test_every_port_module_imports_without_jax_or_pil():
    """Each module of the package on its own, the kernel wrappers
    (ops/window_block.py, ops/block_pair.py, ops/style_block.py,
    ops/phase_conv.py, ops/patch_embed.py, ops/window_attention.py,
    ops/ln_mlp.py), the losses, the training steps, fast adaptation, the
    data pipeline and its native loader, the trainer, the eval grid and its
    command line, the adaptation, conversion and calibration command lines,
    the PNG reader and writer, the profiling hooks, the server and the
    band-owned spatial path (parallel/) included; and the modules the
    spatial and data-parallel tests' ranks import (each rank is a fresh
    process that imports them)."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "mastermetastyletransfer_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    for name in ("ops.block_pair", "ops.style_block", "ops.phase_conv",
                 "ops.patch_embed", "ops.window_attention",
                 "ops.ln_mlp", "losses.vgg", "losses.loss",
                 "train.schedule", "train.state", "train.step", "adapt",
                 "data.pipeline", "data.native_loader", "train.trainer",
                 "utils.convert", "eval.harness", "eval.cli",
                 "utils.convert_cli", "losses.calibrate", "utils.png",
                 "utils.device", "utils.profiling", "serve",
                 "parallel.mesh", "parallel.launch", "parallel.spatial",
                 "parallel.spatial_shmap", "utils.ocdbt", "utils.zarr",
                 "utils.orbax", "utils.checkpoint"):
        assert f"mastermetastyletransfer_tpu_torch.{name}" in modules, name
    probe = _PROBE.replace(
        "import chip_smoke\n",
        "import chip_smoke\nimport importlib\n"
        + "".join(f"importlib.import_module({m!r})\n" for m in modules)
        + "".join(f"importlib.import_module('tests.{w[:-3]}')\n"
                  for w in WORKERS))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("isolated-ok")


_ROUTES = r"""
import os, sys
import numpy as np
folder = sys.argv[1]
from mastermetastyletransfer_tpu_torch import serve
from mastermetastyletransfer_tpu_torch.adapt import _save_image as adapt_save
from mastermetastyletransfer_tpu_torch.data import pipeline
from mastermetastyletransfer_tpu_torch.eval.harness import _save_image
from mastermetastyletransfer_tpu_torch.utils import profiling
import torch

for name in ("a.jpg", "b.png", "c.bmp"):
    path = os.path.join(folder, name)
    with open(path, "rb") as f:
        x = serve._decode_to(48, f.read())
    y = pipeline._decode_resize(path, 48)
    assert x.shape == y.shape == (48, 48, 3)
    assert np.array_equal((x * 255).round().astype(np.uint8), y), name
    reply = serve._encode_jpeg(x)
    assert reply[:3] == b"\xff\xd8\xff"
    assert pipeline.decode_image(reply).shape == (48, 48, 3)
_save_image(x, os.path.join(folder, "grid.jpg"))
adapt_save(x, os.path.join(folder, "adapted.jpg"))
timer = profiling.StepTimer()
with profiling.trace_to(os.path.join(folder, "trace")):
    with profiling.annotate("step"):
        profiling.sync(torch.ones(2) * 2)
    timer.tick()
    timer.tick()
assert timer.mean_step_seconds >= 0
print("isolated-ok")
"""


def test_routes_run_without_jax_or_pil(tmp_path):
    """Not only imports: the request decode and the reply encode of
    ``serve``, the data pipeline's decode of JPEG, PNG and BMP files, the
    eval grid's and the adaptation CLI's image writer and the profiling
    hooks run with PIL and JAX refused."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 56, 3), np.uint8)
    for name, fmt in (("a.jpg", "JPEG"), ("b.png", "PNG"),
                      ("c.bmp", "BMP")):
        Image.fromarray(img).save(tmp_path / name, fmt)
    probe = _PROBE.replace("import chip_smoke\n", _ROUTES)
    proc = subprocess.run([sys.executable, "-c", probe, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("isolated-ok")
    for name in ("grid.jpg", "adapted.jpg"):
        with Image.open(tmp_path / name) as im:
            assert im.format == "JPEG" and im.size == (48, 48)


_CHECKPOINTS = r"""
import json, os, shutil, sys
import torch
from mastermetastyletransfer_tpu_torch import config
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.train.state import create_train_state
from mastermetastyletransfer_tpu_torch.utils import checkpoint

fixtures, out = sys.argv[1], sys.argv[2]
with open(os.path.join(fixtures, "digests.json")) as f:
    digests = json.load(f)
for name, info in digests.items():
    exp = os.path.join(fixtures, name)
    with open(os.path.join(exp, "config.json")) as f:
        cfg = config.ExperimentConfig.from_json(f.read())
    state = create_train_state(init_master_model(
        cfg.model, torch.Generator().manual_seed(0), device="cpu"), cfg.train)
    checkpoint.restore_checkpoint(exp, state)
    assert state.step == info["step"], name
    checkpoint.save_checkpoint(os.path.join(out, name), state, state.step)
    checkpoint.restore_checkpoint(os.path.join(out, name), state)
print("isolated-ok")
"""


def test_orbax_checkpoints_read_and_written_without_jax_or_orbax(tmp_path):
    """The committed JAX-written checkpoints (tests/data/orbax/, both of
    Orbax's layouts) restore into the port's train state, and the port
    writes and reads its own, with JAX, the JAX package, Orbax,
    tensorstore, flax and optax refused."""
    probe = _PROBE.replace("import chip_smoke\n", "").replace(
        'print("isolated-ok")\n', _CHECKPOINTS)
    assert _CHECKPOINTS in probe
    proc = subprocess.run(
        [sys.executable, "-c", probe, str(ROOT / "tests" / "data" / "orbax"),
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("isolated-ok")
