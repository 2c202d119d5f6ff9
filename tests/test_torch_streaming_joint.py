"""PyTorch port, the joint streaming session and ``generate_joint`` over the
encoder variants (causal and rotary, gated with the CSGU linear) against the
JAX package on the CPU.

Split from ``tests/test_torch_streaming.py`` (whose configs, front ends and
audio these tests share) so that the two files run on two workers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.decoding.beam_search import BeamSearchConfig as JBeamCfg
from huggingface_asr_tpu.decoding.generate import generate_joint as j_generate
from huggingface_asr_tpu.models.configs import EBranchformerConfig as JEnc
from huggingface_asr_tpu.models.fast_infer import fused_encoder_ok as j_fused_ok
from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig as JJoint
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder as JJointModel
from huggingface_asr_tpu.serving.streaming import StreamingJointSession as JJointSession
from test_torch_streaming import BUCKETS, _audio, _frontends
from torch_port_helpers import randomize

from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig
from huggingface_asr_tpu_torch.decoding.generate import generate_joint
from huggingface_asr_tpu_torch.interop.from_jax import joint_state_dict_from_flax
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.fast_infer import fused_encoder_ok
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig
from huggingface_asr_tpu_torch.models.joint_ctc_aed import JointCTCAttentionConfig, JointCTCAttentionEncoderDecoder
from huggingface_asr_tpu_torch.serving.streaming import StreamingJointSession

ENC = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64, conv_dim=(8, 8),
           conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1), vocab_size=30, is_causal=True,
           hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, csgu_conv_dropout=0.0,
           final_dropout=0.0)
DEC = dict(vocab_size=30, n_positions=32, n_embd=32, n_layer=1, n_head=2, resid_pdrop=0.0, embd_pdrop=0.0,
           attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=3)
GEN = dict(num_beams=2, max_length=8, ctc_weight=0.3, num_candidates=8, bos_token_id=0, eos_token_id=1,
           pad_token_id=3)
VARIANT_ENC = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64, conv_dim=(8, 8),
                 vocab_size=30, hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                 csgu_conv_dropout=0.0, final_dropout=0.0)


def test_joint_session_matches_jax_and_the_whole_decode():
    """``StreamingJointSession`` on a causal joint model: the best hypothesis
    of every feed equal to the JAX session's, the last one to
    ``generate_joint`` over the whole audio."""
    jcfg = JJoint(encoder=JEnc(**ENC), decoder=JDec(**DEC), ctc_weight=0.3)
    pcfg = JointCTCAttentionConfig(encoder=EBranchformerConfig(**ENC), decoder=GPT2DecoderConfig(**DEC),
                                   ctc_weight=0.3)
    jfe, pfe = _frontends(4)
    audio = _audio(1.5, 3)
    feats, flens = jfe(jnp.asarray(audio)[None], jnp.asarray([len(audio)]))
    shapes = jax.eval_shape(lambda: JJointModel(jcfg).init(jax.random.key(0), feats, flens,
                                                           labels=jnp.zeros((1, 4), jnp.int32),
                                                           label_lengths=jnp.asarray([4])))["params"]
    tree = randomize(shapes, np.random.default_rng(5))
    model = JointCTCAttentionEncoderDecoder(pcfg)
    model.load_state_dict(joint_state_dict_from_flax(tree, pcfg.encoder, pcfg.decoder), strict=True)
    j = JJointSession(JJointModel(jcfg), tree, jfe, JBeamCfg(**GEN), bucket_seconds=BUCKETS)
    p = StreamingJointSession(model, pfe, BeamSearchConfig(**GEN), bucket_seconds=BUCKETS, device="cpu")
    got = None
    for start in range(0, len(audio), 8000):
        got = p.feed(audio[start:start + 8000])
        assert got == j.feed(audio[start:start + 8000]), start
    with torch.no_grad():
        seqs, _ = generate_joint(model, *pfe(torch.from_numpy(audio)[None], torch.tensor([len(audio)])),
                                 BeamSearchConfig(**GEN))
    assert got == [int(t) for t in seqs[0, 0].tolist() if t not in (0, 1, 3)]


@pytest.mark.parametrize("variant", [
    dict(is_causal=True, position_embeddings_type="rotary"),
    dict(context_awareness_type="gated", csgu_use_linear_after_conv=True),
], ids=["causal_rotary", "gated_csgu_linear"])
def test_generate_joint_with_a_variant_encoder(variant):
    """``generate_joint`` over a variant encoder: the fp32 plain route equal to
    JAX's (sequences, scores within 1e-4); the kernel route admitted exactly
    where the fused gate admits the encoder (``fused_encoder=True`` raises
    for a causal or rotary one, and runs the plain K1 pieces for a gated,
    csgu-linear one)."""
    enc = {**VARIANT_ENC, **variant}
    jcfg = JJoint(encoder=JEnc(**enc), decoder=JDec(**DEC), ctc_weight=0.3)
    pcfg = JointCTCAttentionConfig(encoder=EBranchformerConfig(**enc), decoder=GPT2DecoderConfig(**DEC),
                                   ctc_weight=0.3)
    feats = np.random.default_rng(11).standard_normal((2, 64, 80)).astype(np.float32)
    lens = np.asarray([64, 47], np.int32)
    shapes = jax.eval_shape(lambda: JJointModel(jcfg).init(jax.random.key(0), jnp.asarray(feats), jnp.asarray(lens),
                                                           labels=jnp.zeros((2, 4), jnp.int32),
                                                           label_lengths=jnp.asarray([4, 4])))["params"]
    tree = randomize(shapes, np.random.default_rng(6))
    j_seqs, j_scores = j_generate(JJointModel(jcfg), tree, jnp.asarray(feats), jnp.asarray(lens),
                                  JBeamCfg(**GEN), fused_encoder=False)
    model = JointCTCAttentionEncoderDecoder(pcfg)
    model.load_state_dict(joint_state_dict_from_flax(tree, pcfg.encoder, pcfg.decoder), strict=True)
    x, xl = torch.from_numpy(feats), torch.from_numpy(lens)
    with torch.no_grad():
        p_seqs, p_scores = generate_joint(model.eval(), x, xl, BeamSearchConfig(**GEN), fused_encoder=False)
    np.testing.assert_array_equal(p_seqs.numpy(), np.asarray(j_seqs))
    np.testing.assert_allclose(p_scores.numpy(), np.asarray(j_scores), atol=1e-4, rtol=1e-6)
    bf16 = JointCTCAttentionEncoderDecoder(pcfg, torch.bfloat16)
    bf16.load_state_dict(model.state_dict(), strict=True)
    admitted = fused_encoder_ok(pcfg.encoder, torch.bfloat16)
    assert admitted == j_fused_ok(jcfg.encoder, jnp.bfloat16) == ("is_causal" not in variant)
    with torch.no_grad():
        if admitted:
            seqs, _ = generate_joint(bf16.eval(), x, xl, BeamSearchConfig(**GEN), fused_encoder=True)
            assert seqs.shape == p_seqs.shape
        else:
            with pytest.raises(ValueError, match="causal|rotary"):
                generate_joint(bf16.eval(), x, xl, BeamSearchConfig(**GEN), fused_encoder=True)
