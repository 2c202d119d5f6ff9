"""PyTorch port, the joint CTC/attention model: the GPT-2 multi-head decoder,
the joint model's encoder outputs and ``generate_joint`` against the JAX
package's, with one seeded numpy parameter tree carried across by the
``from_jax`` tables. ``generate_joint`` against JAX's (the plain route and
the kernel route against JAX's interpret-mode fused route) is in
``tests/test_torch_aed_generate.py``.

Sizes are JAX ``tests/test_joint_aed.py``'s: a 1-layer 48-wide encoder and a
2-layer 32-wide decoder with one intermediate head (so the joint model has
an ``enc_to_dec_proj``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.configs import EBranchformerConfig as JEnc
from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
from huggingface_asr_tpu.models.gpt2_decoder import GPT2MultiHeadDecoder as JDecoder
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig as JJoint
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder as JModel
from torch_port_helpers import randomize

from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig
from huggingface_asr_tpu_torch.decoding.generate import _expand_beams, generate_joint
from huggingface_asr_tpu_torch.interop.from_jax import (
    decoder_flax_tree_from_state_dict,
    decoder_state_dict_from_flax,
    joint_flax_tree_from_state_dict,
    joint_state_dict_from_flax,
)
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig, GPT2MultiHeadDecoder
from huggingface_asr_tpu_torch.models.joint_ctc_aed import (
    JointCTCAttentionConfig,
    JointCTCAttentionEncoderDecoder,
)

ENC = dict(
    hidden_size=48, num_hidden_layers=1, num_attention_heads=2,
    intermediate_size=96, conv_dim=(8, 8), conv_kernel=(3, 3), conv_stride=(2, 2),
    conv_padding=(1, 1), vocab_size=40,
    hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
    csgu_conv_dropout=0.0, final_dropout=0.0,
)
DEC = dict(
    vocab_size=40, n_positions=64, n_embd=32, n_layer=2, n_head=2,
    head_locations=(1,), head_weights=(0.3, 0.7), lsm_factor=0.1,
    resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    bos_token_id=0, eos_token_id=1, pad_token_id=3,
)


def _shape_tree(module, *args, **kwargs):
    """The Flax params' shapes, without running the init."""
    return jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kwargs))["params"]


def _decoder_tree(cfg, seed):
    tokens = jnp.zeros((1, 3), jnp.int32)
    kw = dict(labels=tokens, label_mask=jnp.ones((1, 3), bool))
    if cfg.add_cross_attention:
        kw.update(encoder_hidden=jnp.zeros((1, 4, cfg.n_embd)), encoder_lengths=jnp.asarray([4]))
    return randomize(_shape_tree(JDecoder(cfg), tokens, **kw), np.random.default_rng(seed))


@pytest.fixture(scope="module")
def joint():
    """(JAX config, port config, numpy tree, features, lengths)."""
    jcfg = JJoint(encoder=JEnc(**ENC), decoder=JDec(**DEC), ctc_weight=0.3)
    pcfg = JointCTCAttentionConfig(encoder=EBranchformerConfig(**ENC), decoder=GPT2DecoderConfig(**DEC))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 80, 80)).astype(np.float32)
    lens = np.array([80, 60], np.int32)
    labels = jnp.asarray(rng.integers(4, 40, (2, 10)), jnp.int32)
    tree = randomize(_shape_tree(JModel(jcfg), jnp.asarray(feats), jnp.asarray(lens), labels=labels,
                                 label_lengths=jnp.asarray([10, 7])), rng)
    return jcfg, pcfg, tree, feats, lens


def _port_model(pcfg, tree, dtype=torch.float32):
    model = JointCTCAttentionEncoderDecoder(pcfg, dtype)
    model.load_state_dict(joint_state_dict_from_flax(tree, pcfg.encoder, pcfg.decoder), strict=True)
    return model.eval()


@pytest.mark.parametrize("variant", ["base", "average_logits", "pos_emb_fixed", "tied"])
def test_decoder_teacher_forced_logits_match_jax(variant):
    """The whole-sequence (teacher-forced) decoder logits, fp32, within 1e-4 of scale."""
    over = {"base": {}, "average_logits": dict(average_logits=True), "pos_emb_fixed": dict(pos_emb_fixed=True),
            "tied": dict(tie_word_embeddings=True, tie_additional_weights=True, average_logits=True)}[variant]
    jcfg, pcfg = JDec(**{**DEC, **over}), GPT2DecoderConfig(**{**DEC, **over})
    tree = _decoder_tree(jcfg, seed=1)
    rng = np.random.default_rng(2)
    B, T, S = 2, 7, 11
    tokens = rng.integers(0, 40, (B, T))
    enc = rng.standard_normal((B, S, 32)).astype(np.float32)
    enc_lens = np.array([11, 6])
    ref = np.asarray(JDecoder(jcfg).apply({"params": tree}, jnp.asarray(tokens), encoder_hidden=jnp.asarray(enc),
                                          encoder_lengths=jnp.asarray(enc_lens)).logits)
    dec = GPT2MultiHeadDecoder(pcfg)
    dec.load_state_dict(decoder_state_dict_from_flax(tree, pcfg), strict=True)
    with torch.no_grad():
        got = dec(torch.from_numpy(tokens), torch.from_numpy(enc), torch.from_numpy(enc_lens)).logits.numpy()
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("variant", ["base", "pos_emb_fixed"])
def test_bf16_decoder_holds_its_product_weights_in_bf16(variant):
    """At bf16 the product weights, tables and heads are rounded once, at
    load, to the values a per-use cast would give; LayerNorm stays fp32; the
    fixed positional table is a buffer outside the state dict. The logits
    stay within 0.05 of scale of the fp32 decoder's."""
    over = {"base": {}, "pos_emb_fixed": dict(pos_emb_fixed=True)}[variant]
    jcfg, pcfg = JDec(**{**DEC, **over}), GPT2DecoderConfig(**{**DEC, **over})
    sd = decoder_state_dict_from_flax(_decoder_tree(jcfg, seed=6), pcfg)
    ref, dec = GPT2MultiHeadDecoder(pcfg), GPT2MultiHeadDecoder(pcfg, torch.bfloat16)
    ref.load_state_dict(sd, strict=True)
    dec.load_state_dict(sd, strict=True)
    for name, p in dec.state_dict().items():
        want = torch.float32 if ".ln_" in name else torch.bfloat16
        assert p.dtype == want and torch.equal(p, sd[name].to(want)), name
    assert set(dec.state_dict()) == set(sd)
    if pcfg.pos_emb_fixed:
        assert dec.pos_table.dtype == torch.bfloat16
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, 40, (2, 7)))
    enc = torch.from_numpy(rng.standard_normal((2, 11, 32)).astype(np.float32))
    enc_lens = torch.tensor([11, 6])
    with torch.no_grad():
        r = ref(tokens, enc, enc_lens).logits
        g = dec(tokens, enc, enc_lens).logits
    assert g.dtype == torch.bfloat16
    assert float((g.float() - r).abs().max()) <= 0.05 * max(1.0, float(r.abs().max()))


def test_cached_decode_equals_the_full_forward():
    """One token at a time through the cache (cross K/V written once from the
    unexpanded encoder state, read by W = 3 beam rows each) equals the
    whole-sequence forward of the same rows."""
    jcfg = JDec(**DEC)
    pcfg = GPT2DecoderConfig(**DEC)
    dec = GPT2MultiHeadDecoder(pcfg)
    dec.load_state_dict(decoder_state_dict_from_flax(_decoder_tree(jcfg, seed=3), pcfg), strict=True)
    rng = np.random.default_rng(4)
    B, W, T, S = 2, 3, 6, 9
    tokens = torch.from_numpy(rng.integers(0, 40, (B * W, T)))
    enc = torch.from_numpy(rng.standard_normal((B, S, 32)).astype(np.float32))
    enc_lens = torch.tensor([9, 5])
    with torch.no_grad():
        full = dec(tokens, _expand_beams(enc, W), _expand_beams(enc_lens, W)).logits
        cache = dec.write_cross_kv(dec.init_cache(B * W, 16), enc)
        steps = [dec(tokens[:, t:t + 1], encoder_lengths=enc_lens, position_offset=torch.full((B * W,), t),
                     cache=cache).logits[:, 0] for t in range(T)]
    torch.testing.assert_close(torch.stack(steps, dim=1), full, atol=1e-5, rtol=1e-5)


def test_conversion_tables_are_inverse(joint):
    jcfg, pcfg, tree, _, _ = joint
    sd = joint_state_dict_from_flax(tree, pcfg.encoder, pcfg.decoder)
    back = joint_flax_tree_from_state_dict(sd, pcfg.encoder, pcfg.decoder)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, tree)))
    lm_cfg = GPT2DecoderConfig(**{**DEC, "add_cross_attention": False, "head_locations": (), "head_weights": (1.0,)})
    lm_tree = _decoder_tree(JDec(**dataclasses.asdict(lm_cfg)), seed=5)
    assert "crossattention" not in lm_tree["h_0"]
    lm_back = decoder_flax_tree_from_state_dict(decoder_state_dict_from_flax(lm_tree, lm_cfg), lm_cfg)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, lm_back, lm_tree)))


def test_encoder_hidden_and_ctc_outputs_match_jax(joint):
    """``encode``: the CTC logits, the projected post-final-LayerNorm state and
    the encoder's ``hidden_states`` (each layer's input, then the final state), fp32."""
    jcfg, pcfg, tree, feats, lens = joint
    jm = JModel(jcfg)
    j_enc, j_hidden = jm.apply({"params": tree}, jnp.asarray(feats), jnp.asarray(lens), method=jm.encode)
    with torch.no_grad():
        p_enc, p_hidden = _port_model(pcfg, tree).encode(torch.from_numpy(feats), torch.from_numpy(lens))
    assert len(p_enc.hidden_states) == len(j_enc.hidden_states) == pcfg.encoder.num_hidden_layers + 1
    pairs = [(p_enc.logits, j_enc.logits), (p_hidden, j_hidden), *zip(p_enc.hidden_states, j_enc.hidden_states)]
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
    np.testing.assert_array_equal(p_enc.logit_lengths.numpy(), np.asarray(j_enc.logit_lengths))
    # decode_step: the first cached step equals the whole-sequence forward's first position
    model = _port_model(pcfg, tree)
    with torch.no_grad():
        cache = model.decoder.write_cross_kv(model.decoder.init_cache(2, 4), p_hidden)
        bos = torch.zeros(2, 1, dtype=torch.int64)
        step = model.decode_step(bos, cache, p_enc.logit_lengths, torch.zeros(2, dtype=torch.int64))
        full = model.decoder(bos, p_hidden, p_enc.logit_lengths).logits
    torch.testing.assert_close(step, full, atol=1e-5, rtol=1e-5)


def test_fused_encoder_true_raises_where_the_kernels_refuse(joint):
    _, pcfg, tree, feats, lens = joint
    with pytest.raises(ValueError, match="dtype"):
        generate_joint(_port_model(pcfg, tree), torch.from_numpy(feats), torch.from_numpy(lens),
                       BeamSearchConfig(max_length=4), fused_encoder=True)


def test_training_half_raises():
    """The training half's head options are ported (held against JAX in
    tests/test_torch_aed_training.py); what still raises is a mixing mode
    the JAX decoder does not have either, naming the field."""
    for over in (dict(mixing_mode="full"), dict(mixing_mode="linear"), dict(mixing_mode="scalar"),
                 dict(connected_residuals=(1,))):
        GPT2MultiHeadDecoder(GPT2DecoderConfig(**{**DEC, **over}))
    with pytest.raises(NotImplementedError, match="mixing_mode"):
        GPT2MultiHeadDecoder(GPT2DecoderConfig(**{**DEC, "mixing_mode": "gated"}))
