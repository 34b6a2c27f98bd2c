from mastermetastyletransfer_tpu_torch.models.master import (
    cast_params, imagenet_denormalize, imagenet_normalize, init_master_model,
    make_stylize_fn, master_apply, stylize_from_features,
)
