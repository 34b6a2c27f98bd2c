"""Precision of the port's forward pass.

* Every float32 stage runs with TF32 off for cuBLAS matmuls and cuDNN
  convolutions, and the caller's setting comes back afterwards
  (models/master.py:_stage_ctx). PyTorch lets cuDNN run float32
  convolutions in TF32 by default, which would make the decoder's float32
  convolutions TF32 on the card. The flags are plain attributes on a CPU
  build too, so the stage context is checked here; chip_smoke.py checks
  the float32 output on the card.
* bfloat16 against the JAX package: the port's bf16 ``master_apply`` with
  the Swin, style-transformer and decoder kernels on (their plain versions
  here; the decoder on its phase-space path) against JAX's bf16
  ``master_apply`` with K1-K7 in interpret mode, at 64^2; and the same in
  the JAX package's round-5 configuration (K11 and K12 rgb128). Bound: per-pixel MAE <= 2e-2 of the mean |JAX output| (two bf16 paths
  round independently through the whole model).
* bfloat16 against float32, the criterion of chip_smoke.py's bf16 slice
  check on a few weight draws: the port's bf16 kernel route (every kernel
  on, their plain versions here, which round where the kernels round) is
  no further from the float32 reference service (kernels off, nine-conv
  decoder) than 1.5 times the bf16 reference service is, over the whole
  image and over its outermost columns, where a wrong K6 pad slot shows
  (and the whole-image ratio misses it, as a planted one shows).
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.models import master as jmaster
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.models import master as tmaster
from mastermetastyletransfer_tpu_torch.utils.checkpoint import params_from_jax

import chip_smoke
from tests.torch_threads import one_torch_thread  # noqa: F401

TF32_FLAGS = (torch.backends.cuda.matmul, torch.backends.cudnn)


@pytest.fixture
def tf32_on():
    """Both TF32 flags on, as PyTorch's cuDNN default; restored after."""
    before = [m.allow_tf32 for m in TF32_FLAGS]
    for m in TF32_FLAGS:
        m.allow_tf32 = True
    yield
    for m, b in zip(TF32_FLAGS, before):
        m.allow_tf32 = b


@pytest.fixture(scope="module")
def model():
    pj = jax.device_get(jmaster.init_master_model(jax.random.PRNGKey(0),
                                                  jcfg.ModelConfig()))
    return pj, params_from_jax(pj)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stages_run_float32_without_tf32(tf32_on, monkeypatch, model, dtype):
    """Each stage of master_apply sees TF32 off at float32 and the caller's
    setting at bfloat16; the caller's setting is back afterwards."""
    seen = {}

    def spy(stage, fn):
        def wrapped(*args, **kwargs):
            seen[stage] = tuple(m.allow_tf32 for m in TF32_FLAGS)
            return fn(*args, **kwargs)
        return wrapped

    for stage, name in (("swin", "swin_backbone_apply"),
                        ("transformer", "style_transformer_apply"),
                        ("decoder", "cnn_decoder_apply")):
        monkeypatch.setattr(tmaster, name, spy(stage, getattr(tmaster, name)))
    cfg = tcfg.ModelConfig(compute_dtype=dtype).with_kernels()
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    out = tmaster.make_stylize_fn(cfg, k=1, device="cpu")(model[1], x, x)
    assert out.shape == (1, 32, 32, 3) and out.dtype == torch.float32
    inside = (False, False) if dtype == "float32" else (True, True)
    assert seen == {"swin": inside, "transformer": inside, "decoder": inside}
    assert all(m.allow_tf32 for m in TF32_FLAGS)


def test_stage_ctx_restores_the_flags_after_an_error(tf32_on):
    cfg = tcfg.ModelConfig(compute_dtype="float32")
    with pytest.raises(RuntimeError):
        with tmaster._stage_ctx(cfg, "decoder"):
            assert not any(m.allow_tf32 for m in TF32_FLAGS)
            raise RuntimeError("stage failed")
    assert all(m.allow_tf32 for m in TF32_FLAGS)


def test_concurrent_float32_stages_keep_tf32_off(tf32_on):
    """Stages of several float32 services (one worker thread each) overlap:
    TF32 stays off until the last one has left, then comes back."""
    cfg = tcfg.ModelConfig(compute_dtype="float32")
    seen, errors = [], []

    def stage(i):
        try:
            for _ in range(50):
                with tmaster._stage_ctx(cfg, "decoder"):
                    time.sleep(0.0002 * (i % 3))
                    seen.append(tuple(m.allow_tf32 for m in TF32_FLAGS))
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=stage, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(seen) == 16 * 50 and set(seen) == {(False, False)}
    assert all(m.allow_tf32 for m in TF32_FLAGS)


def _bf16_master_apply_vs_jax(model, rgb_tail=None):
    """The bf16 ``master_apply`` of the port (every kernel on) and of JAX
    (K1-K7 in interpret mode), optionally with ``rgb_tail``: the per-pixel
    MAE between them must stay within 2e-2 of the mean |JAX output|."""
    pj, pt = model
    cj = jcfg.ModelConfig(compute_dtype="bfloat16")
    cj = cj.replace(swin=cj.swin.replace(use_pallas=True),
                    transformer=cj.transformer.replace(use_pallas=True),
                    decoder=cj.decoder.replace(use_pallas=True))
    if rgb_tail is not None:
        cj = cj.replace(decoder=cj.decoder.replace(rgb_tail=rgb_tail))
    ct = tcfg.ModelConfig.from_dict(cj.to_dict())
    assert ct.decoder.rgb_tail == cj.decoder.rgb_tail
    if rgb_tail is None:
        assert ct == tcfg.ModelConfig(compute_dtype="bfloat16").with_kernels()
    assert ct.decoder.fuse_upsample and ct.decoder.phase2_tail
    pj = jmaster.cast_params(pj, jnp.bfloat16)
    pt = tmaster.cast_params(pt, torch.bfloat16)
    rng = np.random.default_rng(5)
    c, s = (rng.random((1, 64, 64, 3), dtype=np.float32) for _ in range(2))
    want = np.asarray(jmaster.master_apply(pj, jnp.asarray(c), jnp.asarray(s),
                                           cj, k=1), np.float32)
    got = tmaster.make_stylize_fn(ct, k=1, device="cpu")(pt, c, s).numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    mae, scale = np.abs(got - want).mean(), np.abs(want).mean()
    print(f"bf16 port vs JAX: MAE {mae:.6g}, mean |JAX| {scale:.6g}, "
          f"relative {mae / scale:.6g}")
    assert mae <= 2e-2 * scale, (mae, scale)


def test_bf16_master_apply_matches_jax(model):
    _bf16_master_apply_vs_jax(model)


def test_bf16_master_apply_matches_jax_pair_route(model, monkeypatch):
    """The JAX package's round-5 configuration at bf16: the Swin's stages on
    the block-pair kernel (K11, ``MMST_BLOCK_PAIR=1`` on both sides) and
    the decoder's L2 tail with its rgb128 output conv (K12,
    ``rgb_tail="l2k128"``), under the same bound."""
    from mastermetastyletransfer_tpu_torch.ops import block_pair as bpr
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    ran = []
    for mod, name in ((bpr, "window_block_pair_rows_plain"),
                      (pc, "stencil_phase2_rgb128")):
        def spy(*args, fn=getattr(mod, name), name=name, **kwargs):
            ran.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setenv("MMST_BLOCK_PAIR", "1")
    _bf16_master_apply_vs_jax(model, "l2k128")
    assert sorted(ran) == ["stencil_phase2_rgb128"] + [
        "window_block_pair_rows_plain"] * 2   # both Swin stages, conv8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_kernel_route_within_plain_bf16_noise(seed):
    params = tmaster.init_master_model(
        tcfg.ModelConfig(), torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    c, s = (rng.random((2, 64, 64, 3), dtype=np.float32) for _ in range(2))

    def run(cfg):
        fn = tmaster.make_stylize_fn(cfg, k=1, device="cpu")
        return fn(params, c, s).numpy()

    verdict = chip_smoke.bf16_noise_verdict(
        run(chip_smoke.slice_config("bfloat16", True)),
        run(chip_smoke.reference_config("bfloat16")),
        run(chip_smoke.reference_config("float32")))
    print(verdict)
    assert verdict["noise_ratio"] <= chip_smoke.TOL_BF16_NOISE, verdict


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_criterion_catches_a_wrong_pad_slot(seed, monkeypatch):
    """F6: chip_smoke.py's bf16 slice check also holds the outermost output
    columns (the ones K6's pad columns feed) to the noise ratio. The kernel
    route passes both; with K6's left pad slot 3 fed from slot 0's source
    (a wrong slot, planted here through the wrapper) the whole-image ratio
    still passes and the edge ratio fails."""
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc

    params = tmaster.init_master_model(
        tcfg.ModelConfig(), torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    c, s = (rng.random((2, 64, 64, 3), dtype=np.float32) for _ in range(2))

    def run(cfg):
        fn = tmaster.make_stylize_fn(cfg, k=1, device="cpu")
        return fn(params, c, s).numpy()

    plain = run(chip_smoke.reference_config("bfloat16"))
    ref32 = run(chip_smoke.reference_config("float32"))
    kernel_cfg = chip_smoke.slice_config("bfloat16", True)
    good = chip_smoke.bf16_noise_verdict(run(kernel_cfg), plain, ref32)
    assert good["ok"], good

    orig = pc.stencil_phase2_conv_padcols

    def wrong_slot(pp, pk, bias, table, colmaps, relu=True):
        left, right = colmaps
        left = list(left)
        left[3] = left[0]
        return orig(pp, pk, bias, table, (left, right), relu)

    monkeypatch.setattr(pc, "stencil_phase2_conv_padcols", wrong_slot)
    bad = chip_smoke.bf16_noise_verdict(run(kernel_cfg), plain, ref32)
    assert bad["noise_ratio"] <= chip_smoke.TOL_BF16_NOISE, bad
    assert bad["edge_noise_ratio"] > chip_smoke.TOL_BF16_EDGE_NOISE, bad
    assert not bad["ok"]
