"""PyTorch port, fused encoder layer (K1) vs the JAX package.

The plain layer (what a CPU tensor runs) is held against the Pallas
mega-kernel ``ebranchformer_layer(..., interpret=True)`` on the same folded
weights and bf16 input, with ragged lengths, a zero-length row and
T-padding rows past ``t_valid``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.ops import pallas_layer as PL
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels import layer as K1

B, T, T_VALID = 4, 24, 21
LENS = np.asarray([21, 17, 9, 0], np.int32)


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg, tree, _, pmodel = make_models(seed=0)
    lp = tree["wav2vec2"]["encoder"]["layers_0"]
    x = np.random.default_rng(1).standard_normal((B, T, jcfg.hidden_size)).astype(np.float32)
    x_bf = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)  # bf16-exact values
    w = K1.fold_layer_weights(pmodel.wav2vec2.encoder.layers[0], pcfg)
    return jcfg, pcfg, lp, x_bf, w


def _np(a):
    return np.asarray(a, np.float32)


def test_fold_matches_jax(setup):
    jcfg, pcfg, lp, _, w = setup
    D = jcfg.hidden_size
    j = PL.fold_layer_weights(lp, jcfg, T)
    pairs = {
        "wq": w["w_qkv"][:, :D], "wk": w["w_qkv"][:, D:2 * D], "wv": w["w_qkv"][:, 2 * D:],
        "bq_u": w["b_qkv"][:D], "bk": w["b_qkv"][D:2 * D], "bv": w["b_qkv"][2 * D:],
    }
    for name in PL.WEIGHT_FIELDS:
        if name in ("csgu_lin_w", "csgu_lin_b", "rot_cos", "rot_sin", "k_std"):
            continue
        got = pairs.get(name, w.get(name))
        np.testing.assert_array_equal(got.float().numpy().reshape(-1), _np(j[name]).reshape(-1),
                                      err_msg=name)
    tables = K1.relpos_kernel_tables(T, D)
    for name in ("rot_cos", "rot_sin", "k_std"):
        np.testing.assert_array_equal(tables[name].float().numpy(), _np(j[name]), err_msg=name)


@pytest.mark.parametrize("gelu_mode", ["bitexact", "fast"])
def test_plain_layer_matches_pallas_interpret(setup, gelu_mode):
    """Tolerance: the port evaluates GELU once in fp32 and rounds once. Against
    the TPU 'bitexact' profile (XLA's intermediate bf16 roundings) that is
    1-2 bf16 ulp on some elements, so 2^-6 of the output scale, with a mean
    below 2^-7; against the one-rounding 'fast' profile the layer is the same
    computation and almost every element is bit-equal."""
    jcfg, pcfg, lp, x, w = setup
    old = PL.GELU_MODE
    try:
        PL.GELU_MODE = gelu_mode
        ref = _np(PL.ebranchformer_layer(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(LENS), PL.fold_layer_weights(lp, jcfg, T),
            jcfg, bb=2, t_valid=T_VALID, interpret=True))
    finally:
        PL.GELU_MODE = old
    got = K1.ebranchformer_layer(torch.from_numpy(x).bfloat16(), torch.from_numpy(LENS), w, pcfg,
                                 T_VALID, K1.relpos_kernel_tables(T, jcfg.hidden_size))
    got = got.float().numpy()
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    assert d.max() <= 2 ** -6 * max(1.0, np.abs(ref).max()), d.max()
    assert d.mean() <= 2 ** -7, d.mean()
    if gelu_mode == "fast":
        assert np.mean(d == 0) > 0.97, np.mean(d == 0)


def test_rel_attention_zero_length_row_is_uniform():
    """A zero-length utterance in a padded batch stays finite: the finite
    -1e9 mask makes its rows attend uniformly over all T keys."""
    rng = np.random.default_rng(2)
    Bq, Tq, H, dh, D = 2, 16, 2, 32, 64
    # small scores: -1e9 + s rounds to exactly -1e9 in fp32 while |s| < 32
    bf = lambda *s: torch.from_numpy(0.1 * rng.standard_normal(s).astype(np.float32)).bfloat16()
    q_u, k, v, q_rot, k_std = bf(Bq, Tq, H, dh), bf(Bq, Tq, H, dh), bf(Bq, Tq, H, dh), \
        bf(Bq, Tq, H, D), bf(Tq, D)
    out = K1.rel_attention(q_u, k, v, q_rot, k_std, torch.tensor([0, 5], dtype=torch.int32))
    assert torch.isfinite(out.float()).all()
    mean_v = v[0].float().mean(dim=0)  # (H, dh)
    torch.testing.assert_close(out[0].float(), mean_v.expand(Tq, H, dh).bfloat16().float(),
                               rtol=0, atol=2e-2)


def test_cpu_layer_launches_nothing(setup):
    _, pcfg, _, x, w = setup
    _build.reset_launch_counts()
    K1.ebranchformer_layer(torch.from_numpy(x).bfloat16(), torch.from_numpy(LENS), w, pcfg,
                           T_VALID, K1.relpos_kernel_tables(T, pcfg.hidden_size))
    assert sum(_build.LAUNCHES.values()) == 0


def test_mixed_devices_raise():
    a = torch.zeros(8, 32, dtype=torch.bfloat16)
    g = torch.ones(32)
    meta = torch.zeros(32, device="meta")
    with pytest.raises(ValueError):
        K1.layer_norm(a, g, meta, 1e-5)
