"""The device half of the data pipeline (JAX counterpart: data/)."""

from mastermetastyletransfer_tpu_torch.data.pipeline import (  # noqa: F401
    device_preprocess_batch, device_preprocess_pair, repeat_style_to_batch,
)
