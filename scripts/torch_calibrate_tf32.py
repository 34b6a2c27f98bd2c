"""Does chip_smoke.py's `calibrate` phase catch TF32? The phase as it is
(the calibration's float32 VGG19 under TF32 off), then with the
calibration's TF32-off context replaced by a null one, so that cuDNN runs
its float32 convolutions under PyTorch's default ``allow_tf32``. Each
run prints the phase's JSON line (its ``rel_max_vs_cpu`` against the
phase's tolerance); the last line says whether the phase refused the
planted run. Needs one CUDA card; the phase builds no kernel.

    python3 scripts/torch_calibrate_tf32.py
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mastermetastyletransfer_tpu_torch.losses import calibrate  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible to torch", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    with tempfile.TemporaryDirectory() as root:
        chip_smoke.run_calibrate(root, smi)
        calibrate._TF32_OFF = contextlib.nullcontext()
        try:
            chip_smoke.run_calibrate(root, smi + " (TF32 left on)")
        except AssertionError:
            print("planted TF32: refused by the calibrate phase")
            return 0
    print("planted TF32: not caught")
    return 1


if __name__ == "__main__":
    sys.exit(main())
