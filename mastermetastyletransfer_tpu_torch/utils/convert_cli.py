"""Weight-conversion CLI: torch state dicts -> the flat .npz params export
(JAX counterpart: utils/convert_cli.py). It runs on the host (numpy and
torch on the CPU) and writes the .npz key scheme that both packages'
``load_params_npz`` read (reference: codes/utils.py:10-102,
codes/load_pretrained_weights_to_style_transformer.py):

    # torchvision swin_{t,s,b} state dict -> the cut backbone's params
    python -m mastermetastyletransfer_tpu_torch.utils.convert_cli swin \
        --input swin_b.pth --output swin_backbone.npz --variant swin_B

    # torchvision vgg19(+bn) features -> the loss network (BN folded)
    python -m mastermetastyletransfer_tpu_torch.utils.convert_cli vgg19 \
        --input vgg19.pth --output vgg19.npz [--batchnorm]

    # reference-trained style transformer / decoder .pt -> params
    python -m mastermetastyletransfer_tpu_torch.utils.convert_cli \
        style_transformer --input style_transformer.pt --output st.npz
    python -m mastermetastyletransfer_tpu_torch.utils.convert_cli decoder \
        --input decoder.pt --output dec.npz

    # the paper's pretrained-weight surgery: seed the style transformer
    # from an original Swin block (fused qkv split into thirds)
    python -m mastermetastyletransfer_tpu_torch.utils.convert_cli \
        seed_from_swin --input swin_b.pth --output st_seeded.npz

    # a whole model's checkpoint (save_whole_model's layout, the
    # pretrained_model_lambda_is_{2,4}.pt format, reference
    # train_only_inner_loop.py:382-385) -> the full params
    python -m mastermetastyletransfer_tpu_torch.utils.convert_cli \
        whole_model --input pretrained_model_lambda_is_2.pt \
        --output master_lambda2.npz
"""

from __future__ import annotations

import argparse

import torch

from mastermetastyletransfer_tpu_torch.config import (
    ModelConfig, StyleTransformerConfig, SwinConfig,
)
from mastermetastyletransfer_tpu_torch.models.master import init_master_model
from mastermetastyletransfer_tpu_torch.models.style_transformer import (
    init_style_transformer,
)
from mastermetastyletransfer_tpu_torch.utils import checkpoint as ckpt_lib
from mastermetastyletransfer_tpu_torch.utils.convert import (
    convert_cnn_decoder, convert_style_transformer, convert_swin_backbone,
    convert_vgg19, convert_whole_model, load_torch_state_dict,
    seed_style_transformer_from_swin_block,
)

# The seed of the random template whose leaves a conversion does not
# replace.
TEMPLATE_SEED = 0


def _extract_swin_block(sd: dict) -> dict:
    """The 2nd stage-2 SwinTransformerBlock of a torchvision swin state
    dict, re-keyed as the seeding's block scheme ("0." norm1, "1." attn,
    "3." norm2, "4." mlp): the block the reference's surgery takes,
    ModuleList -> 2nd BasicLayer -> 2nd block, features.3.1 in
    torchvision's layout (reference:
    codes/load_pretrained_weights_to_style_transformer.py:16-50). A block
    state dict passes through; raises ValueError where no block is
    found."""
    if any(k.startswith("1.qkv.") for k in sd):
        return sd
    remap = {"norm1.": "0.", "attn.": "1.", "norm2.": "3.", "mlp.0.": "4.fc1.",
             "mlp.3.": "4.fc2."}
    # a whole torchvision model ("features.3.1.") or the reference's cut
    # Sequential(features[:4]) ("3.1.")
    for prefix in ("features.3.1.", "3.1."):
        out = {}
        for k, v in sd.items():
            if not k.startswith(prefix):
                continue
            rest = k[len(prefix):]
            for old, new in remap.items():
                if rest.startswith(old):
                    out[new + rest[len(old):]] = v
                    break
        if out:
            return out
    raise ValueError(
        "no (features.)3.1.* keys found — pass a torchvision swin state "
        "dict, the cut backbone save, or a pre-extracted block state dict")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("kind", choices=["swin", "vgg19", "style_transformer",
                                     "decoder", "seed_from_swin",
                                     "whole_model"])
    ap.add_argument("--input", required=True, help="torch .pt/.pth state dict")
    ap.add_argument("--output", required=True, help=".npz output path")
    ap.add_argument("--variant", default="swin_B")
    ap.add_argument("--batchnorm", action="store_true")
    args = ap.parse_args(argv)

    sd = load_torch_state_dict(args.input)
    template = torch.Generator().manual_seed(TEMPLATE_SEED)
    if args.kind == "whole_model":
        cfg = ModelConfig()
        params = convert_whole_model(
            sd, init_master_model(cfg, template, device="cpu"), cfg)
    elif args.kind == "swin":
        params = convert_swin_backbone(sd,
                                       SwinConfig.for_variant(args.variant))
    elif args.kind == "vgg19":
        params = convert_vgg19(sd, use_batchnorm=args.batchnorm)
    elif args.kind == "style_transformer":
        params = convert_style_transformer(sd, StyleTransformerConfig())
    elif args.kind == "decoder":
        params = convert_cnn_decoder(sd)
    else:  # seed_from_swin
        cfg = StyleTransformerConfig()
        params = seed_style_transformer_from_swin_block(
            _extract_swin_block(sd), init_style_transformer(template, cfg),
            cfg)

    ckpt_lib.save_params_npz(args.output, params)
    n = sum(t.numel() for t in ckpt_lib.flatten_params(params).values())
    print(f"wrote {args.output}: {n:,} params")


if __name__ == "__main__":
    main()
