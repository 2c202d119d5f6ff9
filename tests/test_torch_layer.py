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
    pairs["wp_e"], pairs["wp_o"] = K1.split_pos_weights(w["wp"])
    for name in PL.WEIGHT_FIELDS:
        if name in ("csgu_lin_w", "csgu_lin_b", "rot_cos", "rot_sin", "k_std"):
            continue
        got = pairs.get(name, w.get(name))
        np.testing.assert_array_equal(got.float().numpy().reshape(-1), _np(j[name]).reshape(-1),
                                      err_msg=name)
    tables = K1.relpos_kernel_tables(T, D)
    for name in ("rot_cos", "rot_sin", "k_std"):
        np.testing.assert_array_equal(tables[name].float().numpy(), _np(j[name]), err_msg=name)


@pytest.mark.parametrize("half", [64, 88, 96, 128])
def test_pos_weights_are_a_permutation(half):
    """``pos_weights`` holds wp_e and wp_o exactly, transposed, and puts
    column 8q + 2j + e of each whole 32 columns in row 8j + 2q + e (the
    column the kernel's accumulator lane q holds there); a ragged tail keeps
    its order. ``split_pos_weights`` undoes it."""
    g = torch.Generator().manual_seed(half)
    wp_e, wp_o = torch.randn(3, 5, half, generator=g), torch.randn(3, 5, half, generator=g)
    wp = K1.pos_weights(wp_e, wp_o)
    assert wp.shape == (3, 2 * half, 5)
    e2, o2 = K1.split_pos_weights(wp)
    assert torch.equal(e2, wp_e) and torch.equal(o2, wp_o)
    for r in range(half):
        c, j, q, e = r // 32, (r % 32) // 8, (r % 8) // 2, r % 2
        col = 32 * c + 8 * q + 2 * j + e if r < half - half % 32 else r
        assert torch.equal(wp[:, r], wp_e[:, :, col]) and torch.equal(wp[:, half + r], wp_o[:, :, col])


def test_pos_query_plain_matches_the_jax_positional_query(setup):
    """The plain positional query on the port's fold (``wp``, the rotation
    tables) against the Pallas kernel's own arithmetic on the JAX fold
    (pallas_layer.py:489-499: per-head fp32 products at HIGHEST precision,
    the rotation, one bf16 rounding): within one bf16 rounding of the same
    fp32 values, 2^-7 of the scale."""
    jcfg, pcfg, lp, _, w = setup
    D, H = jcfg.hidden_size, jcfg.num_attention_heads
    dh = D // H
    j = PL.fold_layer_weights(lp, jcfg, T)
    rng = np.random.default_rng(6)
    M = 3 * T
    q_v = np.asarray(jnp.asarray(rng.standard_normal((M, D)), jnp.bfloat16), np.float32)
    t = np.arange(M) % T
    cos_n, sin_n = _np(j["rot_cos"])[t], _np(j["rot_sin"])[t]
    heads = []
    for hd in range(H):
        qvh = jnp.asarray(q_v[:, hd * dh:(hd + 1) * dh], jnp.bfloat16)
        ce = jnp.dot(qvh, j["wp_e"][hd], preferred_element_type=jnp.float32, precision="highest")
        co = jnp.dot(qvh, j["wp_o"][hd], preferred_element_type=jnp.float32, precision="highest")
        heads.append(jnp.concatenate([cos_n * ce + sin_n * co, cos_n * co - sin_n * ce], -1).astype(jnp.bfloat16))
    ref = np.stack([_np(h) for h in heads], axis=1)
    tables = K1.relpos_kernel_tables(T, D)
    got = K1.pos_query_plain(torch.from_numpy(q_v).bfloat16(), w["wp"], tables["rot_cos"], tables["rot_sin"], T)
    assert got.shape == ref.shape
    d = np.abs(got.float().numpy() - ref)
    assert d.max() <= 2 ** -7 * max(1.0, np.abs(ref).max()), d.max()


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
