"""PyTorch port, ``generate_joint`` against the JAX package's on the seeded
model of ``tests/test_torch_aed.py`` (split from it, whose fixture and
helpers these tests share, so that the two files run on two workers): the
plain route at fp32 with and without a converted LM, and the kernel route in
bf16 (on CPU tensors: every kernel's plain version) against the JAX fused
route with its Pallas kernels in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import huggingface_asr_tpu.models.fast_infer as jfi
from huggingface_asr_tpu.decoding.beam_search import BeamSearchConfig as JBeamCfg
from huggingface_asr_tpu.decoding.generate import generate_joint as j_generate
from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder as JModel
from test_torch_aed import _decoder_tree, _port_model, joint  # noqa: F401  (fixture)

from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig, joint_beam_search
from huggingface_asr_tpu_torch.decoding.generate import build_decoder_step, generate_joint
from huggingface_asr_tpu_torch.interop.from_jax import decoder_state_dict_from_flax
from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig, GPT2MultiHeadDecoder


def _lm(seed):
    cfg = dict(vocab_size=40, n_positions=64, n_embd=32, n_layer=2, n_head=2, add_cross_attention=False,
               resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    jcfg, pcfg = JDec(**cfg), GPT2DecoderConfig(**cfg)
    tree = _decoder_tree(jcfg, seed)
    lm = GPT2MultiHeadDecoder(pcfg)
    lm.load_state_dict(decoder_state_dict_from_flax(tree, pcfg), strict=True)
    return jcfg, tree, lm.eval()


@pytest.mark.parametrize("lm_weight", [0.0, 0.3])
def test_generate_joint_matches_jax(joint, lm_weight):
    """The plain route at fp32 with ctc 0.3 (and a converted LM): n-best
    sequences equal, scores within 1e-4."""
    jcfg, pcfg, tree, feats, lens = joint
    kw = dict(num_beams=3, max_length=12, ctc_weight=0.3, lm_weight=lm_weight, num_candidates=16,
              bos_token_id=0, eos_token_id=1, pad_token_id=3)
    lm_jcfg, lm_tree, lm = _lm(seed=6)
    j_seqs, j_scores = j_generate(JModel(jcfg), tree, jnp.asarray(feats), jnp.asarray(lens), JBeamCfg(**kw),
                                  lm_config=lm_jcfg, lm_params=lm_tree, fused_encoder=False)
    with torch.no_grad():
        p_seqs, p_scores = generate_joint(_port_model(pcfg, tree), torch.from_numpy(feats), torch.from_numpy(lens),
                                          BeamSearchConfig(**kw), lm=lm, fused_encoder=False)
    np.testing.assert_array_equal(p_seqs.numpy(), np.asarray(j_seqs))
    np.testing.assert_allclose(p_scores.numpy(), np.asarray(j_scores), atol=1e-4, rtol=1e-6)


def test_generate_joint_fused_route_matches_jax_interpret(joint, capsys):
    """The kernel route in bf16 (on CPU tensors: every kernel's plain version,
    no launch) against the JAX fused route with its Pallas kernels in
    interpret mode.

    - The decode half is held exactly: the port's search on the JAX route's
      own encoder outputs (CTC logits and hidden, bf16) gives JAX's sequences.
    - The whole route: the best hypothesis equal; where a lower-ranked one
      differs, by the near-tie triage rule its score is within bf16 noise
      (0.02 on per-token scores) of JAX's at that rank, and the gap is
      printed. The encoders differ by a few bf16 ulp (the port's numeric
      contract against the JAX ``bitexact`` profile)."""
    jcfg, pcfg, tree, feats, lens = joint
    kw = dict(num_beams=2, max_length=10, ctc_weight=0.3, num_candidates=16,
              bos_token_id=0, eos_token_id=1, pad_token_id=3)
    x, xl = jnp.asarray(feats), jnp.asarray(lens)
    orig = jfi.ctc_infer_fused
    jfi.ctc_infer_fused = functools.partial(orig, interpret=True)
    try:
        j_seqs, j_scores = j_generate(JModel(jcfg, dtype=jnp.bfloat16), tree, x, xl, JBeamCfg(**kw),
                                      fused_encoder=True)
        j_enc, j_hidden = jfi.ctc_infer_fused(tree["encoder"], jcfg.encoder, x, xl, bb=2, return_hidden=True)
    finally:
        jfi.ctc_infer_fused = orig
    j_seqs, j_scores = np.asarray(j_seqs), np.asarray(j_scores)
    model = _port_model(pcfg, tree, torch.bfloat16)
    cfg = BeamSearchConfig(**kw)
    as_bf16 = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
    _build.reset_launch_counts()
    with torch.no_grad():
        p_seqs, p_scores = generate_joint(model, torch.from_numpy(feats), torch.from_numpy(lens), cfg,
                                          fused_encoder=True, fused=FusedCTC(model.encoder, "cpu"))
        j_lengths = torch.from_numpy(np.array(j_enc.logit_lengths))
        step, cache = build_decoder_step(model.decoder, 2 * cfg.num_beams, cfg.max_length,
                                         model.project(as_bf16(j_hidden)), j_lengths)
        d_seqs, _ = joint_beam_search(step, cache, 2, cfg, ctc_log_probs=F.log_softmax(as_bf16(j_enc.logits).float(), -1),
                                      ctc_lengths=j_lengths, vocab_size=pcfg.decoder.vocab_size)
    assert sum(_build.LAUNCHES.values()) == 0
    np.testing.assert_array_equal(d_seqs.numpy(), j_seqs)
    p_seqs, p_scores = p_seqs.numpy(), p_scores.numpy()
    np.testing.assert_array_equal(p_seqs[:, 0], j_seqs[:, 0])
    differ = (p_seqs != j_seqs).any(-1)
    gaps = np.abs(p_scores - j_scores)[differ]
    with capsys.disabled():
        print(f"\nbf16 kernel route vs JAX interpret: {int(differ.sum())} of {differ.size} hypotheses differ, "
              f"score gaps at those ranks {gaps.tolist()}")
    assert np.all(gaps <= 0.02)
