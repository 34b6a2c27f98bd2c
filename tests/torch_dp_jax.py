"""The JAX side of the data-parallel comparisons
(tests/test_torch_data_parallel*_jax.py): JAX's sharded steps on its
8-device CPU mesh (tests/conftest.py) and the port's data-parallel steps
(gloo ranks from tests/torch_dp_workers.py, spawned from one thread while
JAX compiles, one process group after the other) on the same weights and
numpy images; the port's one-device steps on the contents scaled by
(1 + eps), at the ranks' one torch thread, give each leaf's spread.

64^2, swin_B widths, a global batch of 4, ``max_layers=1`` (k = 1 on both
sides), stochastic depth and dropouts at 0 (the two frameworks draw
different masks), weights through ``params_from_jax``. The meta step runs
2 inner updates at outer_lr 0.5 (tests/test_torch_meta.py's), so that
theta moves by more than its rounding.

Bounds, as tests/test_torch_train.py's and tests/test_train.py's: the
loss within 1e-5 relative (the meta step's last inner losses, on omega
after an update whose near-zero gradients take either sign, or within
SPREAD_FACTOR times their own spread); Adam's first moment per leaf
((1 - b1) grad after a plain step) within 1e-4 relative max-abs or
SPREAD_FACTOR times the leaf's spread; the parameters within 2.5 lr
(JAX's own test_data_parallel_train_step_matches_single_device: Adam's
first update is about sign(grad) lr), 2.5 outer_lr n lr after the meta
step.
"""

import concurrent.futures
import contextlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.parallel import make_mesh as jmake_mesh
from mastermetastyletransfer_tpu.train import state as jstate
from mastermetastyletransfer_tpu.train import step as jstep
from mastermetastyletransfer_tpu_torch import config as tcfg
from mastermetastyletransfer_tpu_torch.parallel.launch import spawn_ranks
from mastermetastyletransfer_tpu_torch.utils.checkpoint import flatten_params

from tests import torch_dp_workers as workers
from tests.torch_jax_init import jax_weights, no_depth_drop

SIZE, BATCH, N_INNER, OUTER_LR, SEED = 64, 4, 2, 0.5, 5
TOL_LOSS, TOL_MU = 1e-5, 1e-4
SPREAD_FACTOR = 4
SPREAD_EPS = (2.0 ** -20, 2.0 ** -17)
LOSSES = ("total", "content", "style")


def jax_cfg(mode: str) -> jcfg.ExperimentConfig:
    return jcfg.ExperimentConfig(
        model=no_depth_drop(jcfg.ModelConfig()),
        train=jcfg.TrainConfig(mode=mode, max_layers=1,
                               num_inner_updates=N_INNER,
                               outer_lr=OUTER_LR))


def run(mode: str, ns) -> dict:
    """JAX's sharded step of ``mode`` ("plain" or "meta") at each n of
    ``ns`` and the port's at the same n; the port's one-device spreads."""
    cfg = jax_cfg(mode)
    meta = mode == "meta"
    pj, vj = jax_weights(cfg.model)
    rng = np.random.default_rng(SEED)
    lead = (N_INNER,) if meta else ()
    content = rng.random(lead + (BATCH, SIZE, SIZE, 3), dtype=np.float32)
    style = np.repeat(rng.random((1, SIZE, SIZE, 3), dtype=np.float32),
                      BATCH, 0)
    ct = tcfg.ExperimentConfig.from_dict(cfg.to_dict())
    case = dict(cfg=ct.replace(model=ct.model.with_kernels()),
                weights="jax", content=content, style=style, seed=SEED,
                k=None)
    weights = {"jax": (pj, vj)}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_steps, mode, case, weights, ns)
        want = {n: _jax_step(cfg, pj, vj, content, style, n) for n in ns}
        got = port.result()
    with _torch_threads(1):     # the ranks' (tests/torch_dp_workers.py)
        base, *moved = [workers.run_step(dict(
            case, content=content * np.float32(1 + eps)), weights)
            for eps in (0.0,) + SPREAD_EPS]
    arrays = workers.state_arrays(base[0])["mu"]
    spread = {key: max(float(np.abs(workers.state_arrays(s)["mu"][key]
                                    - m).max()) for s, _ in moved)
              for key, m in arrays.items()}
    spread.update({name: max(abs(m[name] - base[1][name])
                             for _, m in moved) for name in LOSSES})
    return dict(cfg=cfg, pj=pj, want=want, got=got, spread=spread)


@contextlib.contextmanager
def _torch_threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def _port_steps(mode: str, case: dict, weights: dict, ns) -> dict:
    """The port's data-parallel step at each n of ``ns``, one process group
    after the other (never two groups starting together), rank 0's and
    every rank's results by n. A group that fails is reported with its n,
    how long it ran and the host's free memory then, beside the ranks'
    own error (a traceback, or the signal that ended a rank)."""
    got = {}
    for n in ns:
        t0 = time.perf_counter()
        try:
            ranks = spawn_ranks(workers.dp_steps, n, backend="gloo",
                                device="cpu", args=({mode: case}, weights))
        except Exception as e:  # re-raised with the group's circumstances
            raise RuntimeError(
                f"the port's {mode} step on {n} gloo ranks failed after "
                f"{time.perf_counter() - t0:.1f} s, "
                f"{_mem_available_gib():.1f} GiB free: "
                f"{type(e).__name__}: {e}") from e
        got[n] = [r[mode] for r in ranks]
    return got


def _jax_step(cfg, pj, vj, content, style, n):
    tx = jstate.make_optimizer(pj, cfg.train)
    state, tx = jstate.create_train_state(pj, cfg.train, tx)
    make = (jstep.make_meta_train_step if cfg.train.mode == "meta"
            else jstep.make_train_step)
    new, metrics = make(cfg, vj, tx, mesh=jmake_mesh(n))(
        state, jnp.asarray(content), jnp.asarray(style),
        jax.random.PRNGKey(7))
    adam = new.opt_state.inner_states["train"].inner_state[0]
    return dict(params=flatten_params(jax.device_get(new.params)),
                mu=flatten_params(jax.device_get(adam.mu)),
                metrics={name: float(metrics[name]) for name in LOSSES})


def check(res: dict, n: int) -> None:
    """The port's ranks at n against JAX's sharded step at n. Every error
    is measured against its bound first, and the largest share of its
    bound in each group (losses, first moments, parameters) is printed
    before the bounds are asserted, so that a failure's captured output
    says how near the other leaves were."""
    want, ranks, spread = res["want"][n], res["got"][n], res["spread"]
    got = ranks[0]
    meta = res["cfg"].train.mode == "meta"
    assert len({r["digest"] for r in ranks}) == 1
    assert got["metrics"]["k"] == 1
    assert set(got["mu"]) == set(want["mu"])
    shares = {"loss": [], "mu": [], "params": []}   # (share, key, err, bound)
    for name in LOSSES:
        w = want["metrics"][name]
        tol = TOL_LOSS * abs(w)
        if meta:
            tol = max(tol, SPREAD_FACTOR * spread[name])
        err = abs(got["metrics"][name] - w)
        shares["loss"].append((err / tol, name, err, tol))
    for key, m in got["mu"].items():
        w = np.asarray(want["mu"][key])
        err = float(np.abs(m - w).max())
        tol = max(TOL_MU * float(np.abs(w).max()),
                  SPREAD_FACTOR * spread[key])
        shares["mu"].append((err / tol, key, err, tol))
    lr = res["cfg"].train.inner_lr
    bound = 2.5 * lr * (OUTER_LR * N_INNER if meta else 1.0)
    before = flatten_params(res["pj"])
    for key, w in want["params"].items():
        if key in got["params"]:
            err = float(np.abs(got["params"][key] - np.asarray(w)).max())
            shares["params"].append((err / bound, key, err, bound))
        else:      # frozen: the Swin, as it was on both sides
            assert np.array_equal(np.asarray(w), before[key]), key
    for group, rows in shares.items():
        share, key, err, tol = max(rows)
        print(f"{res['cfg'].train.mode} n={n}: largest {group} error "
              f"{share:.3f} of its bound ({key}: {err:.3g} of {tol:.3g})")
    for group, rows in shares.items():
        for share, key, err, tol in rows:
            assert err <= tol, (group, key, err, tol)
