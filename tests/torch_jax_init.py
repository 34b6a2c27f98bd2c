"""JAX-side set-up shared by the port's training tests: the model
configuration with the stochastic-depth probabilities at 0 (the two
frameworks draw different masks), and JAX's weights."""

import jax

from mastermetastyletransfer_tpu import config as jcfg
from mastermetastyletransfer_tpu.losses import vgg as jvgg
from mastermetastyletransfer_tpu.models import master as jmaster


def no_depth_drop(m: jcfg.ModelConfig) -> jcfg.ModelConfig:
    """``m`` with every stochastic-depth probability at 0."""
    return m.replace(
        swin=m.swin.replace(stochastic_depth_probs=(0.0, 0.0, 0.0, 0.0)),
        transformer=m.transformer.replace(encoder_stochastic_depth_prob=0.0,
                                          decoder_stochastic_depth_prob=0.0))


def jax_weights(model_cfg: jcfg.ModelConfig):
    """JAX's model and VGG19 weights (keys 0 and 1) as numpy trees, each
    initializer jitted (18 s on the CPU against 26 s op by op)."""
    pj = jax.jit(jmaster.init_master_model, static_argnums=1)(
        jax.random.PRNGKey(0), model_cfg)
    vj = jax.jit(jvgg.init_vgg19_features)(jax.random.PRNGKey(1))
    return jax.device_get(pj), jax.device_get(vj)
