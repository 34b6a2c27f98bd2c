from mastermetastyletransfer_tpu_torch.models.master import (
    cast_params, encode_features, encode_style_stream, imagenet_denormalize,
    imagenet_normalize, init_master_model, make_stylize_fn, master_apply,
    stylize_from_features, stylize_from_features_with_stream,
    stylize_with_style_stream,
)
