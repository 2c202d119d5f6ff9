"""PyTorch port, the 512-wide encoder (``configs/ebranchformer_90m_ssl.json``:
hidden 512, 8 heads of 64, intermediate 2,048) vs the JAX package, on the CPU.

The kernels' paths past 256 columns of q_rot and past 768 CSGU channels run
only on the card (``tests/test_torch_cuda.py``); here the gates admit the
config, and the plain versions those kernels are held to there agree with
the JAX package at these widths: the fp32 model (attention_impl "xla") to
1e-4 of the scale, the bf16 fused path's plain pieces (the K1 layer at
q_rot 512 and CSGU 1,024 channels) to the JAX fused path in interpret mode
to 0.05 of the scale, and K4's plain forward and backward at (dh 64,
q_rot 512) to the JAX kernel in interpret mode to 2^-6 of each tensor's
scale, the tolerances the narrower widths' tests use. Sizes are cut to two
layers and a few dozen frames; the widths are the config's.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.fast_infer import ctc_infer_fused
from huggingface_asr_tpu.ops.pallas_train_attention import rel_attention_train as j_rel_attention_train
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels import layer as K1
from huggingface_asr_tpu_torch.kernels.train_attention import padded_widths, rel_attention_train, wide_backward
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer, fused_encoder_refusal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "configs", "ebranchformer_90m_ssl.json")) as _f:
    CFG_90M = json.load(_f)
# the config's widths, two layers; no dropout for the comparisons
WIDE = dict(hidden_size=512, num_attention_heads=8, intermediate_size=2048, num_hidden_layers=2,
            conv_dim=(512, 512), csgu_kernel_size=31, merge_conv_kernel=31)
B, T_IN = 2, 96
LENS = np.asarray([96, 61], np.int32)


@pytest.fixture(scope="module")
def models():
    return make_models(seed=7, **WIDE)


@pytest.fixture(scope="module")
def feats():
    return np.random.default_rng(11).standard_normal((B, T_IN, 80)).astype(np.float32)


def test_the_512_wide_config_is_inside_every_gate():
    cfg = EBranchformerConfig.from_dict(CFG_90M)
    assert (cfg.hidden_size, cfg.head_size, cfg.intermediate_size) == (512, 64, 2048)
    assert fused_encoder_refusal(cfg, torch.bfloat16, log_mel=True) is None
    assert padded_widths(64, 512, torch.bfloat16) == (64, 512) and wide_backward(64, 512, torch.bfloat16)
    assert K1.DWCONV_MAX_C[0] >= 1024 and K1.rel_attention_width_ok(K1.rot_width(512))
    z = lambda *s, dtype=torch.float32: torch.zeros(*s, dtype=dtype)  # noqa: E731
    C = cfg.intermediate_size // 2
    assert K1.dwconv_contract(0, z(8, 2 * C, dtype=torch.bfloat16), z(31, C, dtype=torch.bfloat16), z(C), 2, 4, 4,
                              z(C), z(C)) == C
    assert K1.dwconv_contract(1, z(8, 1024, dtype=torch.bfloat16), z(31, 1024, dtype=torch.bfloat16), z(1024),
                              2, 4, 4) == 1024


@pytest.mark.parametrize("hidden,heads,inter,ok", [(512, 8, 2048, True), (448, 7, 1792, True),
                                                  (512, 8, 2304, False), (576, 9, 2048, False)])
def test_fused_gate_at_the_new_limits(hidden, heads, inter, ok):
    """q_rot up to 512 columns and CSGU up to 1,024 channels (whole
    128-channel slices past 768) are taken; 1,152 CSGU channels and q_rot 576
    are not, and the refusal names the limit."""
    cfg = dataclasses.replace(EBranchformerConfig.from_dict(CFG_90M), hidden_size=hidden, num_attention_heads=heads,
                              intermediate_size=inter)
    reason = fused_encoder_refusal(cfg, torch.bfloat16)
    assert (reason is None) == ok, reason
    if not ok:
        assert ("512" in reason) if hidden > 512 else ("1024" in reason)


def test_fp32_model_at_512_matches_flax(models, feats):
    jcfg, pcfg, tree, jmodel, pmodel = models
    assert jcfg.attention_impl in ("auto", "xla") and pcfg.head_size == 64
    ref = jmodel.apply({"params": tree}, jnp.asarray(feats), jnp.asarray(LENS), deterministic=True)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(feats), torch.from_numpy(LENS))
    np.testing.assert_array_equal(got.logit_lengths.numpy(), np.asarray(ref.logit_lengths))
    r, g = np.asarray(ref.logits), got.logits.numpy()
    assert g.shape == r.shape
    assert np.abs(g - r).max() <= 1e-4 * max(1.0, np.abs(r).max())


def test_bf16_fused_path_at_512_matches_fused_interpret(models, feats):
    """The K1 layers' plain pieces at q_rot 512 and CSGU 1,024 channels
    (behind the model's own front end: conv 512 x 512 is outside K2) against
    ``ctc_infer_fused(interpret=True)``; 0.05 of the scale on valid frames."""
    jcfg, pcfg, tree, _, pmodel = models
    ref = ctc_infer_fused(tree, jcfg, jnp.asarray(feats), jnp.asarray(LENS), bb=2, interpret=True)
    fused = FusedCTC(pmodel, "cpu")
    assert fused.subsample is None and fused.layers[0]["wp"].shape == (8, 512, 64)
    _build.reset_launch_counts()
    with torch.no_grad():
        got = ctc_infer(fused, torch.from_numpy(feats), torch.from_numpy(LENS))
    assert sum(_build.LAUNCHES.values()) == 0
    lens = np.asarray(ref.logit_lengths)
    np.testing.assert_array_equal(got.logit_lengths.numpy(), lens)
    r, g = np.asarray(ref.logits, np.float32), got.logits.float().numpy()
    valid = np.arange(r.shape[1])[None, :] < lens[:, None]
    assert np.abs(g - r)[valid].max() <= 0.05 * max(1.0, np.abs(r[valid]).max())


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k4_plain_at_q_rot_512_matches_jax_interpret(rate):
    """K4's plain forward and backward in bf16 at the config's head (64) and
    q_rot (512) widths, with rows of length T, 1 and 0, against the JAX kernel
    in interpret mode: 2^-6 of each tensor's scale."""
    Bq, T, H = 3, 24, 2
    rng = np.random.default_rng(int(rate * 10) + 5)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = dict(q_u=mk(Bq, T, H, 64), q_rot=0.25 * mk(Bq, T, H, 512), k=mk(Bq, T, H, 64), v=mk(Bq, T, H, 64),
             k_std=mk(T, 512), cot=mk(Bq, T, H, 64))
    lengths = np.asarray([T, 1, 0], np.int32)
    names = ("q_u", "q_rot", "k", "v")

    jargs = [jnp.asarray(x[n], jnp.bfloat16) for n in names]

    def jloss(*a):
        out = j_rel_attention_train(*a, jnp.asarray(x["k_std"], jnp.bfloat16), jnp.asarray(lengths), jnp.int32(5),
                                    rate, True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(x["cot"], jnp.bfloat16).astype(jnp.float32)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(*jargs)
    t = {n: torch.from_numpy(x[n]).bfloat16().requires_grad_(True) for n in names}
    out = rel_attention_train(*(t[n] for n in names), torch.from_numpy(x["k_std"]).bfloat16(),
                              torch.from_numpy(lengths), 5, rate)
    out.backward(torch.from_numpy(x["cot"]).bfloat16())
    for name, g, r in zip(("out",) + names, [out.detach()] + [t[n].grad for n in names], [jout] + list(jgrads)):
        g, r = g.float().numpy(), np.asarray(r, np.float32)
        assert np.abs(g - r).max() <= 2 ** -6 * max(1.0, np.abs(r).max()), name
