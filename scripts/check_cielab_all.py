"""Hold the port's CIELab -> sRGB transform (utils/cms.py with
native/cms.cpp) to PIL's ``Image.convert("RGB")`` of a LAB image on all
2^24 (L, a, b) triples, on the CPU (PIL and LittleCMS on this side only):

    python scripts/check_cielab_all.py

Prints one JSON line: the triples, the values compared, those differing,
and the seconds each side took.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> None:
    from PIL import Image

    from mastermetastyletransfer_tpu_torch.utils import cms

    idx = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([(idx >> 16) & 255, (idx >> 8) & 255, idx & 255],
                   -1).astype(np.uint8)
    t0 = time.perf_counter()
    want = np.asarray(Image.frombytes("LAB", (4096, 4096), lab.tobytes())
                      .convert("RGB")).reshape(-1, 3)
    t1 = time.perf_counter()
    cms.lab_clut()
    got = cms.lab_to_rgb(lab)
    t2 = time.perf_counter()
    print(json.dumps({"triples": int(len(lab)), "values": int(want.size),
                      "differing": int(np.count_nonzero(got != want)),
                      "pil_s": t1 - t0, "port_s": t2 - t1}))


if __name__ == "__main__":
    main()
