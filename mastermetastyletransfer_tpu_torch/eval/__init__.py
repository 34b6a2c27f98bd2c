"""The content x style evaluation grid (JAX counterpart: eval/)."""

from mastermetastyletransfer_tpu_torch.eval.harness import (  # noqa: F401
    EvalReport, evaluate_grid, load_eval_images,
)
