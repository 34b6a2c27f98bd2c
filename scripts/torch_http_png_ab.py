"""chip_smoke.py's ``http`` phase three times in one process on the card:
its request bodies as they are (content 4 an Adam7 PNG whose rows take the
five filters, Paeth and Average among them), then with content 4 a PNG of
the same pixels whose rows are all filter 0 (``png_bytes``), then as they
are again. Prints one JSON line a run: the host's ms to decode content 4
(mean of 3), the /stylize p50 and max ms, imgs/s and each route's p50.

    python3 scripts/torch_http_png_ab.py      # from the repository root

It shows what the PNG reader's numpy unfilter of Paeth and Average rows
(``utils/png._unfilter_sweep``) costs the server: the decode holds the
interpreter lock that the handler threads and the services share.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mastermetastyletransfer_tpu_torch.utils.png import png_bytes  # noqa: E402


def filter0_inputs(seed: int = cs.HTTP_SEED) -> dict:
    out = adam7_inputs(seed)
    contents = cs.smooth_images(np.random.default_rng(seed), 8,
                                cs.HTTP_CONTENT_HW)
    out["contents"][4] = png_bytes(contents[4])
    return out


adam7_inputs = cs.http_inputs


def main() -> None:
    cs._build.build_all()
    for label, inputs in (("adam7", adam7_inputs), ("filter0", filter0_inputs),
                          ("adam7_again", adam7_inputs)):
        cs.http_inputs = inputs
        body = inputs()["contents"][4]
        t = time.perf_counter()
        for _ in range(3):
            cs.decode_image(body)
        ms = (time.perf_counter() - t) / 3 * 1e3
        out = cs.run_http()
        print(json.dumps({
            "ab": label, "content4_decode_ms": ms,
            "p50": out["stylize_p50_ms"], "max": out["stylize_max_ms"],
            "imgs_per_s": out["stylize_imgs_per_s"],
            "runs": {k: v["p50_ms"] for k, v in out["runs"].items()}}),
            flush=True)


if __name__ == "__main__":
    main()
