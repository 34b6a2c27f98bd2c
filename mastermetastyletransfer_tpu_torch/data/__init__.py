"""The data pipeline: image folders, samplers and the prefetching loader
on the host, the crops on the device (JAX counterpart: data/)."""

from mastermetastyletransfer_tpu_torch.data.pipeline import (  # noqa: F401
    ImageFolderDataset, InfiniteIndexSampler, PrefetchLoader,
    device_preprocess_batch, device_preprocess_pair, list_images,
    make_train_iterators, repeat_style_to_batch,
)
