"""PyTorch port at head size 44 (the 176-wide configs) vs the JAX package on the CPU.

The attention kernels are compiled for heads of 32 and 64 columns and read
q_rot / k_std in 64-column chunks. A 176-wide model with 4 heads (dh = 44)
runs them on operands padded with zero columns: in the folded layer weights
(K1, ``kernels/layer.py``), in copies made by the wrappers (K4, K5). These
tests hold, at a small size (two layers, width 176, 4 heads), with ragged
lengths that include 1 and 0:

* the padded fold against the JAX fold: its true slices equal, its pads zero;
* the plain layer on the padded fold against the Pallas layer in interpret
  mode, at ``tests/test_torch_layer.py``'s tolerance (2^-6 of the scale);
* ``ctc_infer`` behind the model's own conv front end (conv_dim (176, 176),
  outside the subsampler kernel) against ``ctc_infer_fused(interpret=True)``,
  0.05 of the scale with equal lengths, and its ``return_hidden``;
* the plain K4 forward and VJP at dh 44 against ``rel_attention_train(...,
  interpret=True)``, fp32 and bf16, rates 0 and 0.1, with the keep-mask bit
  for bit; K5's plain version at dh 44 against its Pallas kernel;
* padded and unpadded plain attention agreeing within fp32 rounding;
* the GEMM's contract and the fused path's gate at the new boundary.
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
from huggingface_asr_tpu.ops import pallas_layer as PL
from huggingface_asr_tpu.ops.pallas_attention import rel_attention as j_rel_attention
from huggingface_asr_tpu.ops.pallas_train_attention import _keep_mask
from huggingface_asr_tpu.ops.pallas_train_attention import rel_attention_train as j_rel_attention_train
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.kernels import layer as K1
from huggingface_asr_tpu_torch.kernels.attention import head_width, rel_attention as p_rel_attention
from huggingface_asr_tpu_torch.kernels.train_attention import keep_mask, padded_widths, rel_attention_train
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer, fused_encoder_refusal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the 176-wide configs' widths, two layers, the conv front end the subsampler kernel does not take
NARROW = dict(hidden_size=176, num_attention_heads=4, intermediate_size=352, conv_dim=(176, 176))
D, H, DH = 176, 4, 44
HW, D_ROT = 64, 192


@pytest.fixture(scope="module")
def models():
    return make_models(seed=3, **NARROW)


def _np(a):
    return np.asarray(a, np.float32)


def test_padded_widths():
    assert head_width(DH) == HW and K1.rot_width(D) == D_ROT
    assert head_width(32) == 32 and K1.rot_width(256) == 256  # the flagship's stay unpadded
    assert padded_widths(DH, D, torch.bfloat16) == (HW, D_ROT)
    assert padded_widths(DH, D, torch.float32) == (HW, D)


# ---- K1: the fold, the layer


def test_padded_fold_matches_jax(models):
    """Each head's 44 columns (rows of W_out and the positional projection)
    equal the JAX fold's; every pad column and row is zero."""
    jcfg, pcfg, tree, _, pmodel = models
    T = 64
    lp = tree["wav2vec2"]["encoder"]["layers_0"]
    j = {k: _np(v) for k, v in PL.fold_layer_weights(lp, jcfg, T).items()}
    w = {k: v.float().numpy() for k, v in K1.fold_layer_weights(pmodel.wav2vec2.encoder.layers[0], pcfg).items()}
    assert w["w_qkv"].shape == (D, 3 * H * HW) and w["wo"].shape == (H * HW, D)
    assert w["wp"].shape == (H, D_ROT, HW)
    w["wp_e"], w["wp_o"] = (t.numpy() for t in K1.split_pos_weights(torch.from_numpy(w.pop("wp"))))
    assert w["wp_e"].shape == (H, HW, D_ROT // 2)
    qkv = w["w_qkv"].reshape(D, 3, H, HW)
    bqkv = w["b_qkv"].reshape(3, H, HW)
    for i, (wn, bn) in enumerate((("wq", "bq_u"), ("wk", "bk"), ("wv", "bv"))):
        np.testing.assert_array_equal(qkv[:, i, :, :DH], j[wn].reshape(D, H, DH), err_msg=wn)
        np.testing.assert_array_equal(bqkv[i, :, :DH], j[bn].reshape(H, DH), err_msg=bn)
        assert not qkv[:, i, :, DH:].any() and not bqkv[i, :, DH:].any()
    bq_v = w["bq_v"].reshape(H, HW)
    np.testing.assert_array_equal(bq_v[:, :DH], j["bq_v"].reshape(H, DH))
    assert not bq_v[:, DH:].any()
    wo = w["wo"].reshape(H, HW, D)
    np.testing.assert_array_equal(wo[:, :DH], j["wo"].reshape(H, DH, D))
    assert not wo[:, DH:].any()
    for name in ("wp_e", "wp_o"):
        np.testing.assert_array_equal(w[name][:, :DH, :D // 2], j[name], err_msg=name)
        assert not w[name][:, DH:].any() and not w[name][:, :, D // 2:].any()
    for name in PL.WEIGHT_FIELDS:  # every other operand is the JAX fold's as it is
        if name in j and name not in ("wq", "wk", "wv", "bq_u", "bk", "bv", "bq_v", "wo", "wp_e", "wp_o",
                                      "rot_cos", "rot_sin", "k_std", "csgu_lin_w", "csgu_lin_b"):
            np.testing.assert_array_equal(w[name].reshape(-1), j[name].reshape(-1), err_msg=name)
    tables = {k: v.float().numpy() for k, v in K1.relpos_kernel_tables(T, D).items()}
    half, pad = D // 2, (D_ROT - D) // 2
    for name in ("rot_cos", "rot_sin"):
        np.testing.assert_array_equal(tables[name][:, :half], j[name], err_msg=name)
        assert tables[name].shape == (T, D_ROT // 2) and not tables[name][:, half:].any()
    k_std = tables["k_std"]
    np.testing.assert_array_equal(np.concatenate([k_std[:, :half], k_std[:, half + pad:D_ROT - pad]], 1), j["k_std"])
    assert not k_std[:, half:half + pad].any() and not k_std[:, D_ROT - pad:].any()


def test_padded_plain_layer_matches_pallas_interpret(models):
    """2^-6 of the output scale, mean below 2^-7: tests/test_torch_layer.py's
    tolerance (GELU evaluated once in fp32 against the 'bitexact' profile)."""
    jcfg, pcfg, tree, _, pmodel = models
    B, T, t_valid = 4, 64, 61
    lens = np.asarray([61, 40, 1, 0], np.int32)
    lp = tree["wav2vec2"]["encoder"]["layers_1"]
    x = np.asarray(jnp.asarray(np.random.default_rng(4).standard_normal((B, T, D)), jnp.bfloat16), np.float32)
    ref = _np(PL.ebranchformer_layer(jnp.asarray(x, jnp.bfloat16), jnp.asarray(lens), PL.fold_layer_weights(lp, jcfg, T),
                                     jcfg, bb=2, t_valid=t_valid, interpret=True))
    w = K1.fold_layer_weights(pmodel.wav2vec2.encoder.layers[1], pcfg)
    got = K1.ebranchformer_layer(torch.from_numpy(x).bfloat16(), torch.from_numpy(lens), w, pcfg, t_valid,
                                 K1.relpos_kernel_tables(T, D)).float().numpy()
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    assert d.max() <= 2 ** -6 * max(1.0, np.abs(ref).max()), d.max()
    assert d.mean() <= 2 ** -7, d.mean()


def test_padded_and_unpadded_plain_attention_agree(models):
    """The layer's positional query and attention on the padded fold against
    the same on the unpadded operands (the pads cut away): pad columns of
    q_rot exactly zero, both outputs within fp32 rounding (then one bf16
    rounding of the same value: at most one bf16 ulp apart)."""
    _, pcfg, _, _, pmodel = models
    B, T = 3, 72
    g = torch.Generator().manual_seed(5)
    w = K1.fold_layer_weights(pmodel.wav2vec2.encoder.layers[0], pcfg)
    tab = K1.relpos_kernel_tables(T, D)
    x = torch.randn(B * T, D, generator=g).bfloat16()
    qkv, q_v = K1.gemm_plain(x, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])
    q_rot = K1.pos_query_plain(q_v, w["wp"], tab["rot_cos"], tab["rot_sin"], T)
    half, pad = D // 2, (D_ROT - D) // 2
    assert not q_rot[..., half:half + pad].any() and not q_rot[..., D_ROT - pad:].any()
    true_cols = torch.cat([torch.arange(half), torch.arange(half + pad, D_ROT - pad)])
    wp_e, wp_o = K1.split_pos_weights(w["wp"])
    q_rot_u = K1.pos_query_plain(q_v.view(-1, H, HW)[..., :DH].reshape(-1, H * DH),
                                 K1.pos_weights(wp_e[:, :DH, :half], wp_o[:, :DH, :half]),
                                 tab["rot_cos"][:, :half], tab["rot_sin"][:, :half], T)
    torch.testing.assert_close(q_rot[..., true_cols].float(), q_rot_u.float(), rtol=2 ** -8, atol=1e-6)
    heads = lambda i, n: qkv.view(B, T, 3, H, HW)[:, :, i, :, :n]  # noqa: E731
    lengths = torch.tensor([T, 1, 0], dtype=torch.int32)
    padded = K1.rel_attention_plain(heads(0, HW), heads(1, HW), heads(2, HW), q_rot.view(B, T, H, D_ROT),
                                    tab["k_std"], lengths)
    unpadded = K1.rel_attention_plain(heads(0, DH), heads(1, DH), heads(2, DH),
                                      q_rot.view(B, T, H, D_ROT)[..., true_cols], tab["k_std"][:, true_cols], lengths)
    assert not padded[..., DH:].any()
    torch.testing.assert_close(padded[..., :DH].float(), unpadded.float(), rtol=2 ** -7, atol=2 ** -7)


# ---- the model: K1 behind the model's own front end


@pytest.fixture(scope="module")
def served(models):
    jcfg, pcfg, tree, _, pmodel = models
    B, T_in = 4, 120
    lens = np.asarray([120, 95, 1, 0], np.int32)  # rows of one encoder frame and of none
    feats = np.random.default_rng(6).standard_normal((B, T_in, 80)).astype(np.float32)
    ref, ref_hidden = ctc_infer_fused(tree, jcfg, jnp.asarray(feats), jnp.asarray(lens), bb=2, interpret=True,
                                      return_hidden=True)
    fused = FusedCTC(pmodel, "cpu")
    with torch.no_grad():
        got, hidden = ctc_infer(fused, torch.from_numpy(feats), torch.from_numpy(lens), return_hidden=True)
    return ref, ref_hidden, got, hidden, fused


def test_ctc_infer_behind_the_plain_subsampler_matches_fused_interpret(served):
    """0.05 of the scale on valid frames, equal lengths (as
    tests/test_torch_model.py holds the flagship's fused path)."""
    ref, _, got, _, fused = served
    assert fused.subsample is None and fused.front_end is not None
    lens = np.asarray(ref.logit_lengths)
    np.testing.assert_array_equal(got.logit_lengths.numpy(), lens)
    r, g = _np(ref.logits), got.logits.float().numpy()
    assert g.shape == r.shape and got.logits.dtype == torch.bfloat16
    valid = np.arange(r.shape[1])[None, :] < lens[:, None]
    d = np.abs(g - r)[valid]
    assert d.max() <= 0.05 * max(1.0, np.abs(r[valid]).max()), d.max()


def test_return_hidden_is_the_post_final_ln_state(served):
    """The hidden states (B, T, D) bf16 after the final LayerNorm, within
    0.05 of the scale of the JAX path's on valid frames; the logits are the
    heads applied to them."""
    ref, ref_hidden, got, hidden, fused = served
    r, h = _np(ref_hidden), hidden.float().numpy()
    assert hidden.dtype == torch.bfloat16 and h.shape == r.shape == (*got.logits.shape[:2], D)
    valid = np.arange(r.shape[1])[None, :] < np.asarray(ref.logit_lengths)[:, None]
    assert np.abs(h - r)[valid].max() <= 0.05 * max(1.0, np.abs(r[valid]).max())
    heads = (hidden.float() @ fused.heads_w + fused.heads_b).bfloat16()
    assert torch.equal(heads, got.logits)


def test_plain_ctc_infer_takes_the_same_front_end(models, served):
    """``plain=True`` runs the same front-end modules and the plain layers:
    on the CPU, where the wrappers take the plain versions too, the same logits."""
    _, _, got, _, fused = served
    feats = np.random.default_rng(6).standard_normal((4, 120, 80)).astype(np.float32)
    lens = torch.from_numpy(np.asarray([120, 95, 1, 0], np.int32))
    with torch.no_grad():
        plain = ctc_infer(fused, torch.from_numpy(feats), lens, plain=True)
    assert torch.equal(plain.logits, got.logits)


# ---- K4 and K5 at dh 44


def _k4_inputs(seed, B=3, T=40, lens=(40, 1, 0)):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q_u=mk(B, T, H, DH), q_rot=0.25 * mk(B, T, H, D), k=mk(B, T, H, DH), v=mk(B, T, H, DH),
                k_std=mk(T, D), lengths=np.asarray(lens, np.int32), cot=mk(B, T, H, DH))


def _k4_jax(x, seed, rate, dtype):
    args = [jnp.asarray(x[n], dtype) for n in ("q_u", "q_rot", "k", "v", "k_std")]
    lengths, cot = jnp.asarray(x["lengths"]), jnp.asarray(x["cot"], dtype)

    def loss(q_u, q_rot, k, v):
        out = j_rel_attention_train(q_u, q_rot, k, v, args[4], lengths, jnp.int32(seed), rate, True)
        return jnp.sum(out.astype(jnp.float32) * cot.astype(jnp.float32)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(*args[:4])
    return [_np(out)] + [_np(g) for g in grads]


def _k4_port(x, seed, rate, dtype):
    t = {n: torch.from_numpy(x[n]).to(dtype).requires_grad_(n != "k_std") for n in ("q_u", "q_rot", "k", "v", "k_std")}
    out = rel_attention_train(t["q_u"], t["q_rot"], t["k"], t["v"], t["k_std"], torch.from_numpy(x["lengths"]),
                              seed, rate)
    out.backward(torch.from_numpy(x["cot"]).to(dtype))
    return [out.detach().float().numpy()] + [t[n].grad.float().numpy() for n in ("q_u", "q_rot", "k", "v")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k4_forward_and_vjp_at_head_size_44_match_jax_interpret(dtype, rate):
    """fp32: forward rtol/atol 2e-5, gradients 2e-4 (summation order); bf16:
    2^-6 of each tensor's scale (tests/test_torch_train_attention.py's)."""
    x = _k4_inputs(seed=44)
    got = _k4_port(x, 9, rate, getattr(torch, dtype))
    ref = _k4_jax(x, 9, rate, getattr(jnp, dtype))
    for name, g, r in zip(("out", "dq_u", "dq_rot", "dk", "dv"), got, ref):
        assert np.isfinite(g).all(), name
        if dtype == "float32":
            tol = 2e-5 if name == "out" else 2e-4
            np.testing.assert_allclose(g, r, rtol=tol, atol=tol, err_msg=name)
        else:
            assert np.abs(g - r).max() <= 2 ** -6 * max(1.0, np.abs(r).max()), name


def test_k4_keep_mask_at_four_heads_is_bit_equal_to_the_jax_hash():
    """The mask is keyed by (seed, b, h, t, s, T), not by the head size, so the
    padded kernels drop what the plain version and the JAX kernel drop."""
    B, T, seed, rate = 2, 40, -12345, 0.1
    got = keep_mask(seed, B, H, T, rate).numpy()
    for b in range(B):
        for h in range(H):
            np.testing.assert_array_equal(got[b, h], np.asarray(_keep_mask(jnp.int32(seed), h, b, H, T, rate,
                                                                           interpret=True)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_at_head_size_44_matches_jax_kernel_interpret(dtype):
    """fp32 rtol/atol 2e-5, bf16 2^-6 of the scale (tests/test_torch_attention.py's)."""
    B, T = 3, 32
    rng = np.random.default_rng(45)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = [mk(B, T, H, DH), mk(B, T, H, DH), mk(B, T, H, DH), mk(B, T, H, DH), mk(2 * T - 1, H, DH),
         np.asarray([32, 1, 0], np.int32)]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = _np(j_rel_attention(*[jnp.asarray(a, jd) for a in x[:5]], jnp.asarray(x[5]), interpret=True))
    got = p_rel_attention(*[torch.from_numpy(a).to(td) for a in x[:5]], torch.from_numpy(x[5])).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    else:
        assert np.abs(got - ref).max() <= 2 ** -6 * max(1.0, np.abs(ref).max())


# ---- the boundaries


@pytest.mark.parametrize("n,k", [(176, 176), (176, 352), (704, 176), (768, 176), (176, 704), (8, 8)])
def test_gemm_contract_takes_the_176_wide_products(n, k):
    K1.gemm_contract(torch.zeros(16, k, dtype=torch.bfloat16), torch.zeros(k, n, dtype=torch.bfloat16))
    merged = torch.zeros(16, 2 * D, dtype=torch.bfloat16)  # cg_w2 into merged[:, D:], 352 bytes in
    K1.gemm_contract(torch.zeros(16, 352, dtype=torch.bfloat16), torch.zeros(352, D, dtype=torch.bfloat16),
                     merged[:, D:])


@pytest.mark.parametrize("n,k", [(180, 176), (176, 100), (4, 176), (176, 12)])
def test_gemm_contract_refuses_rows_of_no_whole_16_bytes(n, k):
    with pytest.raises(ValueError):
        K1.gemm_contract(torch.zeros(16, k, dtype=torch.bfloat16), torch.zeros(k, n, dtype=torch.bfloat16))


@pytest.mark.parametrize("name", ["ebranchformer_small_ctc.json", "ed_small.json", "decred_small.json"])
def test_176_wide_configs_take_the_fused_path(name):
    with open(os.path.join(REPO, "configs", name)) as f:
        d = json.load(f)
    cfg = EBranchformerConfig.from_dict(d.get("encoder", d))
    assert cfg.head_size == DH and fused_encoder_refusal(cfg, torch.bfloat16) is None
    # K4 in training takes them too, in both dtypes
    assert padded_widths(cfg.head_size, cfg.hidden_size, torch.bfloat16) == (HW, D_ROT)


def test_512_wide_config_is_admitted():
    """The 512-wide config (head size 64, q_rot 512, CSGU 1,024 channels) takes
    the fused path and K4 in training, unpadded."""
    with open(os.path.join(REPO, "configs", "ebranchformer_90m_ssl.json")) as f:
        cfg = EBranchformerConfig.from_dict(json.load(f))
    assert fused_encoder_refusal(cfg, torch.bfloat16) is None
    assert fused_encoder_refusal(cfg, torch.bfloat16, log_mel=True) is None
    assert padded_widths(64, 512, torch.bfloat16) == (64, 512)
    assert padded_widths(cfg.head_size, cfg.hidden_size, torch.bfloat16) == (64, 512)


def test_fused_ctc_keeps_the_front_end_only_where_k2_does_not_fit(models):
    pmodel = models[4]
    assert FusedCTC(pmodel, "cpu").subsample is None
    flagship_like = dataclasses.replace(pmodel.config, conv_dim=(256, 256))
    from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC

    fused = FusedCTC(EBranchformerForCTC(flagship_like), "cpu")
    assert fused.subsample is not None and fused.front_end is None
