"""PyTorch port, the two inference attention kernels' plain versions and the
fused path's gate, vs the JAX package on the CPU.

``rel_attention_plain`` (the factored form inside the fused layer) has no JAX
function of its own: the Pallas mega-kernel computes it inside one layer. So
it is held through the whole layer at T_pad = 192 (three 64-key tiles; the
lengths end inside the last one and one row has length 0), against
``ebranchformer_layer(..., interpret=True)``, and directly against a float64
numpy evaluation of the same formula. ``rel_attention_plain_shift`` is held
against the Pallas kernel in interpret mode and its XLA reference at T = 70
and 72 (one ragged tile of the CUDA kernel; table rows below 0 and past 2T - 2
belong to its band there). Tolerances as in tests/test_torch_layer.py and
tests/test_torch_attention.py.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.ops import pallas_layer as PL
from huggingface_asr_tpu.ops.pallas_attention import rel_attention as j_rel_attention
from huggingface_asr_tpu.ops.pallas_attention import rel_attention_reference
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels import layer as K1
from huggingface_asr_tpu_torch.kernels.attention import rel_attention, rel_attention_plain_shift
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.fast_infer import fused_encoder_ok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(hidden_size=256, num_hidden_layers=12, num_attention_heads=8, intermediate_size=1024,
                conv_dim=(256, 256), conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1),
                vocab_size=500)


# ---- the fused path's gate


def test_fused_gate_accepts_the_flagship_config():
    assert fused_encoder_ok(EBranchformerConfig(**FLAGSHIP), torch.bfloat16)


@pytest.mark.parametrize("hidden,heads", [(544, 17), (576, 18), (640, 20), (768, 24), (1024, 32)])
def test_fused_gate_refuses_widths_the_attention_kernel_does_not_take(hidden, heads):
    """Head size 32, but the q_rot width, padded to whole 64-column chunks, is
    past 512. (Widths up to 512 that are no multiple of 64 are taken: the fold
    pads them.)"""
    cfg = EBranchformerConfig(**{**FLAGSHIP, "hidden_size": hidden, "num_attention_heads": heads})
    assert cfg.head_size == 32
    assert not K1.rel_attention_width_ok(K1.rot_width(hidden))
    assert not fused_encoder_ok(cfg, torch.bfloat16)


@pytest.mark.parametrize("hidden,heads", [(64, 2), (128, 4), (192, 6), (256, 8), (96, 3), (160, 5), (32, 1),
                                          (288, 9), (320, 10), (384, 12), (512, 16)])
def test_fused_gate_accepts_every_width_the_attention_kernel_takes(hidden, heads):
    cfg = EBranchformerConfig(**{**FLAGSHIP, "hidden_size": hidden, "num_attention_heads": heads})
    assert K1.rel_attention_width_ok(K1.rot_width(hidden)) and fused_encoder_ok(cfg, torch.bfloat16)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "ebranchformer_*.json"))))
def test_shipped_configs_with_head_size_32_pass_the_width_gate(path):
    with open(path) as f:
        cfg = EBranchformerConfig.from_dict(json.load(f))
    # every shipped config with head size 32 is 256 wide and stays on the fused
    # path; so do the 176-wide ones (head size 44, padded) and the 512-wide one
    # (head size 64, q_rot 512)
    assert fused_encoder_ok(cfg, torch.bfloat16)
    if cfg.head_size == 32:
        assert cfg.hidden_size == 256 and K1.rel_attention_width_ok(cfg.hidden_size)


# ---- rel_attention_plain (factored form)

T192, T_VALID = 192, 187
LENS192 = np.asarray([187, 150, 0, 131], np.int32)  # the last two tiles ragged; one empty row


def _factored_inputs(B, T, H, D, seed):
    rng = np.random.default_rng(seed)
    bf = lambda scale, *s: torch.from_numpy(  # noqa: E731
        (scale * rng.standard_normal(s)).astype(np.float32)).bfloat16()
    # scores stay below 32 in size: -1e9 + s then rounds to exactly -1e9 in
    # fp32, which is what makes an empty row uniform
    return bf(0.5, B, T, H, 32), bf(1.0, B, T, H, 32), bf(1.0, B, T, H, 32), bf(0.25, B, T, H, D), bf(1.0, T, D)


@pytest.mark.parametrize("T,lens", [(192, [187, 150, 0, 131]), (64, [64, 1, 0, 33])])
def test_rel_attention_plain_matches_float64_formula(T, lens):
    """softmax2 over [q_u | q_rot] . [k | k_std] with the finite -1e9 mask,
    normalised after P.V: bf16 output within one ulp (2^-7 of the scale) of a
    float64 evaluation, and the zero-length row uniform over all T keys."""
    B, H, D = 4, 2, 64
    q_u, k, v, q_rot, k_std = _factored_inputs(B, T, H, D, seed=T)
    lengths = torch.tensor(lens, dtype=torch.int32)
    # strided views of one (B*T, 3 * H * 32) buffer, as the layer passes them
    qkv = torch.cat([t.reshape(B * T, H * 32) for t in (q_u, k, v)], dim=1)
    views = [qkv[:, i * H * 32:(i + 1) * H * 32].view(B, T, H, 32) for i in range(3)]
    got = K1.rel_attention_plain(*views, q_rot, k_std, lengths).float().numpy()
    f64 = lambda t: t.double().numpy()  # noqa: E731
    s = np.einsum("bthd,bshd->bhts", f64(q_u), f64(k)) + np.einsum("bthD,sD->bhts", f64(q_rot), f64(k_std))
    # keys past the length take no part; an empty row's scores all become
    # -1e9 (the fp32 sum swallows a score below 32), so it is uniform
    lens_np = np.asarray(lens)[:, None, None, None]
    s = np.where(lens_np > 0, np.where(np.arange(T)[None, None, None, :] < lens_np, s, -np.inf), 0.0)
    p = np.exp2(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhts,bshd->bthd", p / p.sum(-1, keepdims=True), f64(v))
    assert got.shape == ref.shape and np.isfinite(got).all()
    # P is rounded to bf16 before P.V (2^-9 relative per term) and the output once more
    assert np.abs(got - ref).max() <= 2 ** -7 * max(1.0, np.abs(ref).max())
    zero = lens.index(0)
    np.testing.assert_allclose(got[zero], np.broadcast_to(f64(v)[zero].mean(0), got[zero].shape), atol=2e-2)


@pytest.fixture(scope="module")
def layer192():
    jcfg, pcfg, tree, _, pmodel = make_models(seed=4)
    lp = tree["wav2vec2"]["encoder"]["layers_0"]
    x = np.random.default_rng(6).standard_normal((4, T192, jcfg.hidden_size)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    x[2] = 0.0  # the empty utterance's rows are zeroed before the first layer
    w = K1.fold_layer_weights(pmodel.wav2vec2.encoder.layers[0], pcfg)
    return jcfg, pcfg, lp, x, w


def test_plain_layer_matches_pallas_interpret_over_three_key_tiles(layer192):
    """The whole layer at T_pad = 192, which holds ``rel_attention_plain`` past
    one 64-key tile with ragged lengths and an empty row. Tolerance as
    tests/test_torch_layer.py::test_plain_layer_matches_pallas_interpret."""
    jcfg, pcfg, lp, x, w = layer192
    old = PL.GELU_MODE
    try:
        PL.GELU_MODE = "fast"
        ref = np.asarray(PL.ebranchformer_layer(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(LENS192), PL.fold_layer_weights(lp, jcfg, T192),
            jcfg, bb=2, t_valid=T_VALID, interpret=True), np.float32)
    finally:
        PL.GELU_MODE = old
    _build.reset_launch_counts()
    got = K1.ebranchformer_layer(torch.from_numpy(x).bfloat16(), torch.from_numpy(LENS192), w, pcfg,
                                 T_VALID, K1.relpos_kernel_tables(T192, jcfg.hidden_size)).float().numpy()
    assert sum(_build.LAUNCHES.values()) == 0
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    assert d.max() <= 2 ** -6 * max(1.0, np.abs(ref).max()), d.max()
    assert d.mean() <= 2 ** -7, d.mean()


# ---- rel_attention_plain_shift


def _shift_inputs(B, T, lens, seed, H=2, dh=8):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [mk(B, T, H, dh), mk(B, T, H, dh), mk(B, T, H, dh), mk(B, T, H, dh), mk(2 * T - 1, H, dh),
            np.asarray(lens, np.int32)]


def _port(x, dtype=torch.float32, fn=rel_attention_plain_shift):
    args = [torch.from_numpy(a).to(dtype) for a in x[:5]] + [torch.from_numpy(x[5])]
    return fn(*args).float().numpy()


def test_shift_plain_matches_jax_reference_at_70():
    x = _shift_inputs(3, 70, [70, 33, 0], seed=70)
    ref = np.asarray(rel_attention_reference(*[jnp.asarray(a) for a in x]))
    np.testing.assert_allclose(_port(x), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(_port(x), _port(x, fn=rel_attention))


def test_shift_plain_matches_jax_kernel_interpret_at_72():
    # the Pallas kernel's roll needs T a multiple of 8 in interpret mode too:
    # 72 is the next one past 70 and is still one ragged 64-key tile and a bit
    x = _shift_inputs(3, 72, [72, 70, 0], seed=72)
    ref = np.asarray(j_rel_attention(*[jnp.asarray(a) for a in x], interpret=True))
    np.testing.assert_allclose(_port(x), ref, rtol=2e-5, atol=2e-5)


def test_shift_plain_bf16_matches_jax_reference_at_70():
    x = _shift_inputs(3, 70, [70, 1, 0], seed=71)
    got = _port(x, torch.bfloat16)
    ref = np.asarray(rel_attention_reference(*[jnp.asarray(a, jnp.bfloat16) for a in x[:5]],
                                             jnp.asarray(x[5])), np.float32)
    assert np.abs(got - ref).max() <= 2 ** -6 * max(1.0, np.abs(ref).max())
