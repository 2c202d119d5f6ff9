"""PyTorch port, conv subsampler (K2) vs the JAX package.

The plain subsampler (what a CPU tensor runs) is held against the Pallas
kernel ``conv_subsample_fused(..., interpret=True)`` on the same params and
seeded features, as tests/test_pallas_subsample.py runs it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.ops.pallas_subsample import conv_subsample_fused
from huggingface_asr_tpu.ops.pallas_subsample import fits_subsample_kernel as j_fits
from huggingface_asr_tpu.ops.pallas_subsample import fold_subsample_weights as j_fold
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.kernels import subsample as K2


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg, tree, _, pmodel = make_models(seed=3, hidden_size=256, num_hidden_layers=1)
    w = K2.fold_subsample_weights(pmodel.wav2vec2, pcfg)
    return jcfg, pcfg, tree, w


def _np(a):
    return np.asarray(a, np.float32)


def test_fold_matches_jax(models):
    jcfg, pcfg, tree, w = models
    j = j_fold(tree["wav2vec2"], jcfg)
    C, D = 256, jcfg.hidden_size
    np.testing.assert_array_equal(w["w2"].float().numpy(), _np(j["sub_W2"]).reshape(9 * C, C))
    np.testing.assert_array_equal(w["wout"].float().numpy(), _np(j["sub_Wout"]).reshape(-1, D))
    np.testing.assert_array_equal(w["wproj"].float().numpy(), _np(j["sub_Wproj"]))
    # conv1 taps: JAX packs both output parities into a (16, 2C) im2col matrix;
    # its even-parity rows (r, kf) for r < 3 are exactly the (kt, kf) taps.
    np.testing.assert_array_equal(w["w1"].float().numpy(), _np(j["sub_B"])[:9, :C])
    for name, jname in (("b1", "sub_b1"), ("b2", "sub_b2"), ("bout", "sub_bout"),
                        ("bproj", "sub_bproj"), ("ln_g", "sub_ln_g"), ("ln_b", "sub_ln_b")):
        np.testing.assert_array_equal(w[name].numpy(), _np(j[jname]).reshape(-1)[: w[name].shape[0]])


@pytest.mark.parametrize("t_in", [96, 100])  # 4-aligned and odd-tail shapes
def test_plain_subsample_matches_pallas_interpret(models, t_in):
    """Tolerance 6e-2 as tests/test_pallas_subsample.py:69: identical rounding
    points; fp32 accumulation order and the GELU's rounding chain flip
    isolated bf16 ulps, which the LN + projection tail amplifies."""
    jcfg, pcfg, tree, w = models
    feats = np.random.default_rng(0).standard_normal((2, t_in, 80)).astype(np.float32)
    T2 = ((t_in - 1) // 2) // 2 + 1
    T2_pad = -(-T2 // 8) * 8
    ref = _np(conv_subsample_fused(tree["wav2vec2"], jcfg, jnp.asarray(feats), T2_pad=T2_pad,
                                   interpret=True))[:, :T2]
    got = K2.conv_subsample(torch.from_numpy(feats), w, pcfg, T2_pad)
    assert got.shape == (2, T2_pad, jcfg.hidden_size) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy()[:, :T2], ref, rtol=0, atol=6e-2)


@pytest.mark.parametrize("change", [
    {}, {"conv_dim": (128, 128)}, {"is_causal": True}, {"context_awareness_type": "gated"},
    {"conv_stride": (2, 1)}, {"feat_extract_activation": "relu"}, {"num_fbanks": 64},
])
def test_gate_matches_jax(models, change):
    jcfg, pcfg, _, _ = models
    assert K2.fits_subsample_kernel(dataclasses.replace(pcfg, **change)) == j_fits(
        dataclasses.replace(jcfg, **change))
