"""Shared setup for the tests that hold the PyTorch port against the JAX package.

One seeded numpy parameter tree feeds both packages: the Flax model reads it
as its params, the port loads it through ``state_dict_from_flax``.
"""

import numpy as np

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel
from huggingface_asr_tpu_torch.interop.from_jax import state_dict_from_flax
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC

# 2 layers, D=128, I=256, k=7; the fused subsampler's gate forces conv_dim (256, 256).
SMALL = dict(
    hidden_size=128, num_hidden_layers=2, num_attention_heads=4, intermediate_size=256,
    conv_dim=(256, 256), conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1),
    csgu_kernel_size=7, merge_conv_kernel=7, vocab_size=50,
    hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
    csgu_conv_dropout=0.0, final_dropout=0.0,
)


def randomize(tree, rng):
    """Seeded params of useful scale: kernels ~ N(0, 1/fan_in), LayerNorm
    scales ~ 1 + N(0, 0.1^2), biases and position biases ~ N(0, 0.1^2)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        z = rng.standard_normal(shape).astype(np.float32)
        if k == "kernel":
            z = z / np.sqrt(np.prod(shape[:-1]))
        elif k == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        out[k] = z.astype(np.float32)
    return out


def make_models(seed=0, **overrides):
    """(jax config, port config, numpy param tree, Flax fp32 model, port model)."""
    kw = {**SMALL, **overrides}
    jcfg, pcfg = JConfig(**kw), EBranchformerConfig(**kw)
    jmodel = JModel(jcfg, dtype=jnp.float32)
    x = jnp.zeros((1, 64, jcfg.num_fbanks), jnp.float32)
    # only the tree's shapes are used: the values are drawn by ``randomize``
    params = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), x, jnp.asarray([64], jnp.int32)))["params"]
    tree = randomize(params, np.random.default_rng(seed))
    pmodel = EBranchformerForCTC(pcfg)
    pmodel.load_state_dict(state_dict_from_flax(tree, pcfg), strict=True)
    return jcfg, pcfg, tree, jmodel, pmodel.eval()
