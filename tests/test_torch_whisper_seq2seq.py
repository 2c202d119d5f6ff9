"""PyTorch port, the Whisper seq2seq model against the JAX package on the
CPU, and the ``transformers`` Whisper checkpoints loaded into the port.

``WhisperForConditionalGeneration`` takes one seeded numpy parameter tree on
both sides (the port's through the ``from_jax`` tables); ``generate_whisper``
runs the beam search with forced and suppressed tokens on both; a tiny
``transformers`` Whisper loads into the port strictly. Everything is fp32;
the tolerances of ``tests/test_torch_whisper.py`` (whose shapes and helpers
these tests share; split from it so that the two files run on two workers).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.decoding.beam_search import BeamSearchConfig as JBeam
from huggingface_asr_tpu.decoding.generate import generate_whisper as j_generate_whisper
from huggingface_asr_tpu.models.whisper_seq2seq import WhisperForConditionalGeneration as JS2S
from huggingface_asr_tpu.models.whisper_seq2seq import WhisperSeq2SeqConfig as JS2SConfig
from test_torch_whisper import LENS, S2S, _close, _feats

from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig
from huggingface_asr_tpu_torch.decoding.generate import generate_whisper
from huggingface_asr_tpu_torch.interop.from_jax import whisper_seq2seq_state_dict_from_flax
from huggingface_asr_tpu_torch.interop.hf_whisper import (
    encoder_state_dict_from_hf,
    load_hf_whisper_checkpoint,
    seq2seq_state_dict_from_hf,
)
from huggingface_asr_tpu_torch.models.whisper_ctc import WhisperCTCConfig, WhisperEncoderForCTC
from huggingface_asr_tpu_torch.models.whisper_seq2seq import WhisperForConditionalGeneration, WhisperSeq2SeqConfig
from torch_port_helpers import randomize


# ---------------------------------------------------------------- seq2seq

@pytest.fixture(scope="module")
def s2s():
    jm, rng = JS2S(JS2SConfig(**S2S)), np.random.default_rng(0)
    x = _feats(rng)
    labels = rng.integers(4, 40, (3, 6)).astype(np.int32)
    ll = np.array([6, 3, 2], np.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(LENS),
                                            labels=jnp.asarray(labels), label_lengths=jnp.asarray(ll)))["params"]
    tree = randomize(shapes, rng)
    pm = WhisperForConditionalGeneration(WhisperSeq2SeqConfig(**S2S))
    pm.load_state_dict(whisper_seq2seq_state_dict_from_flax(tree, pm.config), strict=True)
    return jm, pm.eval(), tree, x, labels, ll


def test_seq2seq_logits_and_loss_match_jax(s2s):
    jm, pm, tree, x, labels, ll = s2s
    jo = jm.apply({"params": tree}, jnp.asarray(x), jnp.asarray(LENS), labels=jnp.asarray(labels),
                  label_lengths=jnp.asarray(ll))
    with torch.no_grad():
        po = pm(torch.from_numpy(x), torch.from_numpy(LENS), torch.from_numpy(labels), torch.from_numpy(ll))
    _close(po.logits.numpy(), jo.logits)
    _close(po.encoder_hidden.numpy(), jo.encoder_hidden)
    np.testing.assert_array_equal(po.encoder_lengths.numpy(), np.asarray(jo.encoder_lengths))
    np.testing.assert_allclose(float(po.loss), float(jo.loss), rtol=1e-5)


def test_cached_decode_matches_full_forward(s2s):
    """Each cached step's logits equal the full teacher-forced forward's at
    that position (within 1e-5 of scale), as the JAX test holds its model."""
    _, pm, _, x, labels, ll = s2s
    with torch.no_grad():
        full = pm(torch.from_numpy(x), torch.from_numpy(LENS), torch.from_numpy(labels),
                  torch.from_numpy(ll)).logits
        enc, enc_lengths = pm.encode(torch.from_numpy(x), torch.from_numpy(LENS))
        cache = pm.write_cross_kv(pm.init_cache(3, 8), enc)
        dec_in = torch.cat([torch.zeros(3, 1, dtype=torch.long), torch.from_numpy(labels[:, :-1]).long()], 1)
        steps = [pm.decode_step(dec_in[:, t:t + 1], torch.full((3,), t), cache, enc_lengths)[:, 0]
                 for t in range(labels.shape[1])]
    _close(torch.stack(steps, 1).numpy(), full.numpy())


def test_generate_whisper_matches_jax_with_forced_and_suppressed_tokens(s2s):
    jm, pm, tree, x, _, _ = s2s
    kw = dict(num_beams=3, max_length=10, ctc_weight=0.0, num_candidates=8, bos_token_id=0, eos_token_id=1,
              pad_token_id=3)
    forced, suppress, begin = ((1, 5), (2, 7)), (9, 11, 20), (12,)
    j_seqs, j_scores = j_generate_whisper(jm, jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(LENS),
                                          JBeam(**kw), forced_decoder_ids=forced, suppress_tokens=suppress,
                                          begin_suppress_tokens=begin)
    with torch.no_grad():
        seqs, scores = generate_whisper(pm, torch.from_numpy(x), torch.from_numpy(LENS), BeamSearchConfig(**kw),
                                        forced_decoder_ids=forced, suppress_tokens=suppress,
                                        begin_suppress_tokens=begin)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(j_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores), rtol=0, atol=1e-5)
    assert not np.isin(seqs.numpy(), suppress).any()
    assert (seqs[:, :, 1] == 5).all() and (seqs[:, :, 2] == 7).all()


# ---------------------------------------------------------------- HF interop

def _hf_config():
    transformers = pytest.importorskip("transformers")
    return transformers.WhisperConfig(
        vocab_size=60, num_mel_bins=80, d_model=32, encoder_layers=2, encoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_layers=2, decoder_attention_heads=2, decoder_ffn_dim=64,
        max_source_positions=50, max_target_positions=16, decoder_start_token_id=1, eos_token_id=2,
        pad_token_id=3, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, attn_implementation="eager")


def test_an_hf_whisper_encoder_loads_strictly_with_equal_hidden_states():
    from transformers.models.whisper.modeling_whisper import WhisperEncoder

    hf_cfg = _hf_config()
    torch.manual_seed(0)
    ref = WhisperEncoder(hf_cfg).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 100, 80)).astype(np.float32))
    with torch.no_grad():
        golden = ref(x.transpose(1, 2)).last_hidden_state
    port = WhisperEncoderForCTC(WhisperCTCConfig(d_model=32, encoder_layers=2, encoder_attention_heads=2,
                                                 encoder_ffn_dim=64, max_source_positions=50, vocab_size=10,
                                                 llm_dim=16, additional_head_count=2))
    missing, unexpected = port.load_state_dict(encoder_state_dict_from_hf(ref.state_dict()), strict=False)
    assert not unexpected and all(not k.startswith("encoder.") for k in missing)
    port.encoder.load_state_dict({k[len("encoder."):]: v for k, v in encoder_state_dict_from_hf(
        ref.state_dict()).items()}, strict=True)
    with torch.no_grad():
        hidden, lengths, _ = port.encoder(x)
    _close(hidden.numpy(), golden.numpy())
    assert lengths.tolist() == [50, 50]


def test_an_hf_whisper_seq2seq_loads_strictly_with_equal_logits(tmp_path):
    """From memory and from an HF directory (``save_pretrained`` with
    ``pytorch_model.bin``): strict loading, logits equal HF's; a directory
    that holds only safetensors raises, naming the file the port reads."""
    from transformers import WhisperForConditionalGeneration as HFWhisper

    hf_cfg = _hf_config()
    torch.manual_seed(0)
    ref = HFWhisper(hf_cfg).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 100, 80)).astype(np.float32))
    dec_in = torch.from_numpy(rng.integers(4, 60, (2, 7)))
    dec_in[:, 0] = 1
    with torch.no_grad():
        golden = ref(input_features=x.transpose(1, 2), decoder_input_ids=dec_in).logits
    port = WhisperForConditionalGeneration(WhisperSeq2SeqConfig.from_hf_config(hf_cfg))
    port.load_state_dict(seq2seq_state_dict_from_hf(ref.state_dict()), strict=True)
    ref.save_pretrained(tmp_path / "bin", safe_serialization=False)
    config, state = load_hf_whisper_checkpoint(str(tmp_path / "bin"))
    assert config == port.config
    from_dir = WhisperForConditionalGeneration(config)
    from_dir.load_state_dict(state, strict=True)
    for model in (port, from_dir):
        with torch.no_grad():
            enc, enc_lengths = model.encode(x)
            logits = model.model.decoder(dec_in, torch.float32, enc, enc_lengths)
        _close(logits.numpy(), golden.numpy())
    ref.save_pretrained(tmp_path / "st", safe_serialization=True)
    assert not os.path.exists(tmp_path / "st" / "pytorch_model.bin")
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        load_hf_whisper_checkpoint(str(tmp_path / "st"))
