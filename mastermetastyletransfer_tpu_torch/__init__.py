"""PyTorch and CUDA port of the MasterMetaStyleTransfer pipeline for one
NVIDIA H100 (Hopper, ``sm_90a``).

The module names follow the JAX package beside it, so each function has a
counterpart of the same name; public tensors are NHWC, as there. The port
imports torch and numpy only.

Layout:
  config.py   configuration dataclasses (own copy; accepts the JAX JSON)
  ops/        window geometry, norms, MLP, attention, convs, and the
              wrappers of the hand-written kernels in csrc/ (built by
              ops/_build.py): the evaluation blocks K1-K4, the decoder's
              phase convs K5-K7, the training kernels K8-K10 with their
              backward passes
  models/     Swin backbone, style transformer, CNN decoder, full model
  losses/     VGG19 features and the perceptual loss
  train/      the plain and Reptile meta steps (remat, gradient
              accumulation), Adam, the lr schedule
  data/       the device half of the data pipeline (crops, style repeat)
  utils/      parameter loading (flat .npz key scheme, JAX param trees)
  inference.py, serve.py   bucketed stylization and the services
  adapt.py    few-shot adaptation to one style image
"""

__version__ = "0.1.0"
