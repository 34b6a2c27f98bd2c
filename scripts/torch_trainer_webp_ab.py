"""chip_smoke.py's ``trainer`` phase four times in one process on the card,
its two WebP contents (``TRAINER_KINDS``: tests/data/webp/trainer_*.webp)
read as WebP or replaced by JPEGs of the same pixels (the port's encoder,
quality 95) under names that sort to the same places: jpeg, webp, webp,
jpeg. Prints one JSON line a run: the trainer's imgs/s over iterations
2-6, a step's ms, the ms between steps, the loader's ms for the batch of
the new kinds, and the host's ms to read the two files (mean of 3).

    python3 scripts/torch_trainer_webp_ab.py      # from the repository root

Every other file and the index stream are the same in both arms, so the
difference is what reading WebP (the port's decoder, then Pillow's
BILINEAR in numpy through ``_decode_resize``) costs the trainer against
the native loader's prescaled JPEG route.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

WEBP_KINDS = cs.TRAINER_KINDS
WEBP_BODIES = cs.kind_bodies
JPEG_KINDS = tuple(n.replace(".webp", ".jpg") for n in WEBP_KINDS)


def jpeg_bodies(rng) -> dict:
    """kind_bodies with each WebP file as a JPEG of its pixels."""
    out = {}
    for name, body in WEBP_BODIES(rng).items():
        if name.endswith(".webp"):
            name = name.replace(".webp", ".jpg")
            body = cs.encode_jpeg(cs.decode_image(body), 95)
        out[name] = body
    return out


def main() -> None:
    cs._build.build_all()
    train = {"imgs_per_s_kernels_on": None, "imgs_per_s_by_k_on": None}
    for arm in ("jpeg", "webp", "webp", "jpeg"):
        cs.TRAINER_KINDS, cs.kind_bodies = (
            (WEBP_KINDS, WEBP_BODIES) if arm == "webp"
            else (JPEG_KINDS, jpeg_bodies))
        bodies = [b for n, b in cs.kind_bodies(np.random.default_rng(0))
                  .items() if n.startswith("kind_webp")]
        t = time.perf_counter()
        for _ in range(3):
            for body in bodies:
                cs.decode_image(body)
        read_ms = (time.perf_counter() - t) / 3 * 1e3
        out = cs.run_trainer(train)
        print(json.dumps({
            "ab": arm, "two_files_read_ms": read_ms,
            "trainer_imgs_per_s_it2_6": out["trainer_imgs_per_s_it2_6"],
            "step_ms_it2_6": out["step_ms_it2_6"],
            "between_steps_ms_it2_5": out["between_steps_ms_it2_5"],
            "kinds_loader_ms_per_batch": out["kinds_loader_ms_per_batch"],
            "files": out["kinds_loader_files"]}), flush=True)


if __name__ == "__main__":
    main()
