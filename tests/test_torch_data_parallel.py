"""The port's data parallelism (parallel/mesh.py, train/step.py with a
mesh, the sharded data pipeline) against the port's own one-device step,
float32 on the CPU.

The ranks run over gloo, each a process started by the port's launcher
(parallel/launch.py) from tests/torch_dp_workers.py, which imports no JAX;
the one-device steps run here. 64^2 images, swin_B widths (ModelConfig's
defaults, stochastic depth at its probabilities), a global batch of 4, k
drawn in [1, 2], weights from a seed, images from numpy seeds. Each rank
steps on its rows of the global batch (``DataShard.rows``): the plain step
at n = 2 and 4; the meta step (2 inner updates), fast adaptation and
``grad_accum_steps`` = 2 at n = 2.

Bounds: the losses within 1e-6 relative; each trainable leaf's gradient,
read as Adam's first moment after the one update ((1 - b1) grad), within
1e-5 relative max-abs (max|a - b| / max|b|) of the one-device step's, or
SPREAD_FACTOR times the leaf's own spread, whichever is larger. The
spread is how far the one-device step's moment moves when the contents
are scaled by (1 + eps), eps in SPREAD_EPS (one and eight units in the
last place, chip_smoke.py's TRAIN_SPREAD_EPS): the ranks' sums round
otherwise than the one-device step's, and at this input one unit in the
last place of the contents moves the f32 gradient of a dozen leaves by
1e-4 to 1.2e-3 relative (the keys' biases, whose gradient is exactly zero
but for rounding, by 1 to 1.5; the encoder's key MLP by 1.2e-3), as far
as the ranks' gradients lie from it (measured at n = 2 and 4). The meta
step reports its last inner step's losses, on omega after one Adam
update, which a gradient's rounding moves by 2 lr where the gradient is
near zero and takes either sign: there the losses too are held within
1e-6 relative or SPREAD_FACTOR times their own spread (as in
tests/test_torch_meta.py). After the step every rank's weights, moments,
step and count are bit-equal (a digest per rank).

The pieces, here in this process for each rank of n: the loader's and the
crops' rows, the stochastic-depth masks and the Swin's stacked batches'
masks against the global draw, and the refusals. JAX's sharded steps:
tests/test_torch_data_parallel*_jax.py.
"""

import contextlib

import numpy as np
import pytest
import torch

from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.data import pipeline
from mastermetastyletransfer_tpu_torch.ops import mlp
from mastermetastyletransfer_tpu_torch.parallel import (
    DataShard, make_mesh,
)
from mastermetastyletransfer_tpu_torch.parallel.launch import spawn_ranks
from mastermetastyletransfer_tpu_torch.train.step import make_train_step

from tests import torch_dp_workers as workers
from tests.torch_threads import two_torch_threads  # noqa: F401

SIZE, BATCH, MAX_K, SEED = 64, 4, 2, 3
TOL_LOSS, TOL_GRAD = 1e-6, 1e-5
SPREAD_FACTOR = 4
SPREAD_EPS = (2.0 ** -23, 2.0 ** -20)
LOSSES = ("total", "content", "style")


def _cfg(mode="plain", **train):
    return tcfg.ExperimentConfig(
        model=tcfg.ModelConfig().with_kernels(),
        data=tcfg.DataConfig(batch_size_content=BATCH, crop_to=SIZE),
        train=tcfg.TrainConfig(mode=mode, max_layers=MAX_K,
                               num_inner_updates=2, **train))


def _cases():
    rng = np.random.default_rng(SEED)

    def images(*lead):
        return rng.random(lead + (BATCH, SIZE, SIZE, 3), dtype=np.float32)

    content, style = images(), np.repeat(images()[:1], BATCH, 0)
    base = dict(weights="seeded", style=style, k=None)
    return {
        "plain": dict(base, cfg=_cfg(), content=content, seed=10),
        "meta": dict(base, cfg=_cfg("meta"), content=images(2), seed=11),
        "fast_adaptation": dict(base, cfg=_cfg("fast_adaptation"),
                                content=content, seed=12),
        "accum": dict(base, cfg=_cfg(grad_accum_steps=2), content=content,
                      seed=13),
    }


CASES = _cases()
WEIGHTS = {"seeded": SEED}
RUNS = {2: tuple(CASES), 4: ("plain",)}


@pytest.fixture(scope="module")
def single():
    """Each case's one-device step on the global batch, and each leaf's
    spread: how far its moment moves when the contents are scaled by
    (1 + eps), eps in SPREAD_EPS."""
    out = {}
    for label, case in CASES.items():
        state, metrics = workers.run_step(case, WEIGHTS)
        out[label] = dict(metrics=metrics, **workers.state_arrays(state))
        spread = dict.fromkeys([*out[label]["mu"], *LOSSES], 0.0)
        for eps in SPREAD_EPS:
            state, moved = workers.run_step(dict(
                case, content=case["content"] * np.float32(1 + eps)),
                WEIGHTS)
            for key, m in workers.state_arrays(state)["mu"].items():
                spread[key] = max(spread[key], float(np.abs(
                    m - out[label]["mu"][key]).max()))
            for name in LOSSES:
                spread[name] = max(spread[name],
                                   abs(moved[name] - metrics[name]))
        out[label]["spread"] = spread
    return out


def _spawn(n):
    cases = {label: CASES[label] for label in RUNS[n]}
    return spawn_ranks(workers.dp_steps, n, backend="gloo", device="cpu",
                       args=(cases, WEIGHTS))


@pytest.fixture(scope="module")
def ranks2():
    """Each rank's results at n = 2, spawned once."""
    return _spawn(2)


@pytest.fixture(scope="module")
def ranks4():
    return _spawn(4)


def _check(label, got, want):
    """got: rank 0's result; want: the one-device step's."""
    for name in LOSSES:
        w = want["metrics"][name]
        assert abs(got["metrics"][name] - w) <= max(
            TOL_LOSS * abs(w), SPREAD_FACTOR * want["spread"][name]), (
            label, name, got["metrics"][name], w, want["spread"][name])
    assert got["metrics"]["k"] == want["metrics"]["k"]
    if "ks" in want["metrics"]:
        assert got["metrics"]["ks"] == want["metrics"]["ks"]
    assert set(got["mu"]) == set(want["mu"])
    for key, w in want["mu"].items():
        err = float(np.abs(got["mu"][key] - w).max())
        tol = max(TOL_GRAD * float(np.abs(w).max()),
                  SPREAD_FACTOR * want["spread"][key])
        assert err <= tol, (label, key, err / float(np.abs(w).max()),
                            want["spread"][key])


@pytest.mark.parametrize("n", sorted(RUNS))
def test_ranks_hold_their_rows(request, n):
    results = request.getfixturevalue(f"ranks{n}")
    for label in RUNS[n]:
        accum = max(CASES[label]["cfg"].train.grad_accum_steps, 1)
        rows = [r[label]["rows"] for r in results]
        assert rows == [DataShard(r, n, accum).rows(BATCH).tolist()
                        for r in range(n)]
        assert sorted(sum(rows, [])) == list(range(BATCH))


@pytest.mark.parametrize("n", sorted(RUNS))
def test_plain_step_equals_one_device(request, single, n):
    """(a): the plain step, stochastic depth on, k drawn, at n = 2 and 4;
    every rank's state bit-equal."""
    results = request.getfixturevalue(f"ranks{n}")
    _check(f"plain n={n}", results[0]["plain"], single["plain"])
    assert len({r["plain"]["digest"] for r in results}) == 1


@pytest.mark.parametrize("mode", ["meta", "fast_adaptation", "accum"])
def test_mode_equals_one_device(ranks2, single, mode):
    """(b): the meta step, fast adaptation and accumulation at n = 2."""
    _check(f"{mode} n=2", ranks2[0][mode], single[mode])
    assert len({r[mode]["digest"] for r in ranks2}) == 1


# ---------------------------------------------------------------------------
# (d) the data: every rank of n here in this process, by its DataShard
# ---------------------------------------------------------------------------

SHARDS = ((2, 1), (2, 2), (4, 1))       # (n, grad_accum_steps)


class _Indexed:
    """A dataset whose image i is filled with i; records each batch of
    indices it decodes."""

    def __init__(self, n):
        self.n, self.decoded = n, []

    def __len__(self):
        return self.n

    def get_batch(self, indices):
        self.decoded.append(list(indices))
        return np.stack([np.full((2, 2, 3), i, np.uint8) for i in indices])


def _take(loader, count):
    try:
        return [next(loader) for _ in range(count)]
    finally:
        loader.close()


@pytest.mark.parametrize("n,accum", SHARDS)
def test_loader_rows_put_together_are_the_batch(n, accum):
    """Each rank's loader, on the one-device loader's seed, decodes only its
    rows of each global index group; placed at their rows, the ranks'
    batches are the one-device loader's, batch for batch."""
    want = np.stack(_take(pipeline.PrefetchLoader(
        _Indexed(11), BATCH, num_workers=2, seed=5), 4))
    sampler = iter(pipeline.InfiniteIndexSampler(11, 5))
    groups = [[next(sampler) for _ in range(BATCH)] for _ in range(16)]
    got = np.zeros_like(want)
    for r in range(n):
        shard = DataShard(r, n, accum)
        ds = _Indexed(11)
        batches = _take(pipeline.PrefetchLoader(
            ds, BATCH, num_workers=2, seed=5, shard=shard), 4)
        got[:, shard.rows(BATCH)] = np.stack(batches)
        mine = [[g[i] for i in shard.rows(BATCH)] for g in groups]
        assert len(ds.decoded) >= 4
        assert all(idx in mine for idx in ds.decoded), ds.decoded
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,accum", SHARDS)
@pytest.mark.parametrize("groups", [1, 2])
def test_crops_are_the_global_draw_rows(n, accum, groups):
    """The ranks' random crop offsets are the global batch's at their
    rows, for one batch and for the meta step's flattened inner batches
    (``groups``); the first style is repeated to the rank's rows."""
    cfg = _cfg()
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, (groups * BATCH, 80, 80, 3),
                                       np.uint8))
    style = torch.from_numpy(rng.integers(0, 256, (1, 80, 80, 3), np.uint8))
    want, want_s = pipeline.device_preprocess_pair(
        cfg, u8, style, generator=torch.Generator().manual_seed(7))
    for r in range(n):
        shard = DataShard(r, n, accum)
        rows = np.concatenate([g * BATCH + shard.rows(BATCH)
                               for g in range(groups)])
        got, got_s = pipeline.device_preprocess_pair(
            cfg, u8[rows], style, generator=torch.Generator().manual_seed(7),
            shard=shard, groups=groups)
        assert torch.equal(got, want[rows])
        assert torch.equal(got_s, want_s[:BATCH // n])


@pytest.mark.parametrize("n", [2, 4])
def test_masks_are_the_global_draw_rows(n):
    """Under ``data_shard`` each rank's stochastic-depth keep mask and
    dropout mask are the global draw's at its rows, windows grouped by
    image too, and with ``stacked_batches(2)`` (the Swin's one pass over
    contents and styles) its rows of each of the two batches; every rank
    leaves the generator where the global draw does."""
    b, nw = BATCH, 3

    def draws(x_sd, x_win, stacked, shard=None):
        g = torch.Generator().manual_seed(9)
        ctx = mlp.data_shard(*shard) if shard else contextlib.nullcontext()
        with ctx, mlp.stacked_batches(stacked):
            sd = mlp.stochastic_depth(x_sd, 0.5, deterministic=False,
                                      generator=g)
            drop = mlp.dropout(x_win, 0.5, deterministic=False, generator=g)
        return sd, drop, g.get_state()

    for stacked in (1, 2):
        x_sd = torch.ones(stacked * b, 4, 4, 5)
        x_win = torch.ones(stacked * b * nw, 6, 5)
        want = draws(x_sd, x_win, stacked)
        for r in range(n):
            rows = np.concatenate([s * b + DataShard(r, n).rows(b)
                                   for s in range(stacked)])
            win = (rows[:, None] * nw + np.arange(nw)).reshape(-1)
            got = draws(x_sd[rows], x_win[win], stacked, (r, n))
            assert torch.equal(got[0], want[0][rows])
            assert torch.equal(got[1], want[1][win])
            assert torch.equal(got[2], want[2])


# ---------------------------------------------------------------------------
# (e) refusals
# ---------------------------------------------------------------------------

def test_batch_that_does_not_divide_is_refused():
    with pytest.raises(ValueError, match=r"batch of 6 .* 4 ranks x "
                                         r"grad_accum_steps=1"):
        DataShard(0, 4).rows(6)
    with pytest.raises(ValueError, match=r"batch of 4 .* 2 ranks x "
                                         r"grad_accum_steps=4"):
        DataShard(1, 2, 4).rows(4)
    with pytest.raises(ValueError, match="batch of 3"):
        pipeline.PrefetchLoader(_Indexed(5), 3, num_workers=1,
                                shard=DataShard(0, 2))
    assert DataShard(1, 2, 2).rows(8).tolist() == [2, 3, 6, 7]


def test_data_parallel_step_needs_a_process_group():
    """No mesh without an initialised process group (make_mesh's
    RuntimeError), so no data-parallel step either."""
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_train_step(_cfg(), {}, device="cpu",
                        mesh=make_mesh(2, device_type="cpu"))
