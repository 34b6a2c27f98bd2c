"""How far f32's order of sums alone moves the whole stylize at the CPU
tests' shapes: the per-pixel MAE and max-abs of JAX's own band path, the
port's single-device ``master_apply`` and the port's band path, each
against JAX's single-device ``master_apply``, at 64x64 on standard-normal
inputs (JAX's band test's), k = 1 and 3, n = 2 and 4, with the weights
and helpers of tests/test_torch_parallel_stylize.py. One JSON line per
(route, k); the last line the mean |output| per k. The band tests' MAE
bound (tests/torch_parallel_jax.py) rests on these numbers. On the CPU,
with JAX (8 virtual devices) and the port's gloo ranks:

    JAX_PLATFORMS=cpu python scripts/torch_band_noise.py
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mastermetastyletransfer_tpu_torch.models.master import (  # noqa: E402
    master_apply,
)
from tests import torch_parallel_jax as tpj  # noqa: E402


def main() -> int:
    torch.set_num_threads(2)
    pj, pt = tpj.model()
    cj, ct = tpj.configs(False)
    c, s = tpj.images(64, 64, 1, 0)
    means = {}
    for k in tpj.KS:
        want = tpj.jax_master(pj, cj, c, s, k)
        means[k] = float(np.abs(want).mean())
        with torch.inference_mode():
            routes = {"port master_apply": master_apply(
                pt, torch.from_numpy(c), torch.from_numpy(s), ct,
                k=k).numpy()}
        for n in tpj.BANDS:
            routes[f"jax band n={n}"] = tpj.jax_shmap(pj, cj, c, s, k, n)
            got, _ = tpj.port_bands(pt, ct, c, s, n, [("out", k, "shmap")])
            routes[f"port band n={n}"] = got["out"]
        for route, out in routes.items():
            err = np.abs(out - want)
            print(json.dumps({"route": route, "k": k,
                              "mae_vs_jax_master": float(err.mean()),
                              "max_abs_vs_jax_master": float(err.max())}),
                  flush=True)
    print(json.dumps({"mean_abs_output": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
