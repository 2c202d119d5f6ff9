"""PyTorch port, the Whisper recipe models against the JAX package on the CPU.

``WhisperEncoderForCTC`` (plain head, ``learnable_blank_head``, ``sub_sample``)
and the seq2seq ``WhisperForConditionalGeneration`` take one seeded numpy
parameter tree on both sides (the port's through the ``from_jax`` tables);
``generate_whisper`` runs the beam search with forced and suppressed tokens
on both; a tiny ``transformers`` Whisper loads into the port strictly.
Everything is fp32. Tolerances: logits within 1e-5 of their largest
magnitude, losses within 1e-5 relative, beam scores within 1e-5 absolute.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.decoding.beam_search import BeamSearchConfig as JBeam
from huggingface_asr_tpu.decoding.generate import generate_whisper as j_generate_whisper
from huggingface_asr_tpu.models.whisper_ctc import WhisperCTCConfig as JCTCConfig
from huggingface_asr_tpu.models.whisper_ctc import WhisperEncoderForCTC as JCTC
from huggingface_asr_tpu.models.whisper_seq2seq import WhisperForConditionalGeneration as JS2S
from huggingface_asr_tpu.models.whisper_seq2seq import WhisperSeq2SeqConfig as JS2SConfig

from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig
from huggingface_asr_tpu_torch.decoding.generate import generate_whisper
from huggingface_asr_tpu_torch.interop.from_jax import (
    whisper_ctc_flax_tree_from_state_dict,
    whisper_ctc_state_dict_from_flax,
    whisper_seq2seq_state_dict_from_flax,
)
from huggingface_asr_tpu_torch.interop.hf_whisper import (
    encoder_state_dict_from_hf,
    load_hf_whisper_checkpoint,
    seq2seq_state_dict_from_hf,
)
from huggingface_asr_tpu_torch.models.whisper_ctc import (
    WhisperCTCConfig,
    WhisperEncoderForCTC,
    whisper_output_lengths,
)
from huggingface_asr_tpu_torch.models.whisper_seq2seq import WhisperForConditionalGeneration, WhisperSeq2SeqConfig
from huggingface_asr_tpu_torch.training.loop import CTCTrainer, TrainerConfig
from torch_port_helpers import randomize

CTC = dict(d_model=32, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=64, max_source_positions=64,
           llm_dim=48, additional_head_count=4, vocab_size=20)
S2S = dict(d_model=32, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=64, decoder_layers=2,
           decoder_attention_heads=4, decoder_ffn_dim=64, max_source_positions=64, max_target_positions=32,
           vocab_size=40, decoder_start_token_id=0, eos_token_id=1, pad_token_id=3)
LENS = np.array([100, 77, 41], np.int32)  # padded rows in every batch


def _feats(rng, T=100):
    return rng.standard_normal((3, T, 80)).astype(np.float32)


def _close(port, ref, scale_tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=0, atol=scale_tol * np.abs(ref).max())


def _ctc_pair(extra, seed=0):
    jm, rng = JCTC(JCTCConfig(**CTC, **extra)), np.random.default_rng(seed)
    x = _feats(rng)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(LENS)))["params"]
    tree = randomize(shapes, rng)
    pm = WhisperEncoderForCTC(WhisperCTCConfig(**CTC, **extra))
    pm.load_state_dict(whisper_ctc_state_dict_from_flax(tree, pm.config), strict=True)
    return jm, pm, tree, x


@pytest.mark.parametrize("extra", [{}, {"learnable_blank_head": True}, {"sub_sample": True}],
                         ids=["plain", "learnable_blank_head", "sub_sample"])
def test_whisper_ctc_logits_lengths_and_loss_match_jax(extra):
    jm, pm, tree, x = _ctc_pair(extra)
    rng = np.random.default_rng(5)
    labels = rng.integers(1, 20, (3, 5)).astype(np.int32)
    ll = np.array([5, 3, 2], np.int32)
    jo = jm.apply({"params": tree}, jnp.asarray(x), jnp.asarray(LENS), labels=jnp.asarray(labels),
                  label_lengths=jnp.asarray(ll))
    with torch.no_grad():
        po = pm(torch.from_numpy(x), torch.from_numpy(LENS), torch.from_numpy(labels), torch.from_numpy(ll))
    _close(po.logits.numpy(), jo.logits)
    np.testing.assert_array_equal(po.logit_lengths.numpy(), np.asarray(jo.logit_lengths))
    np.testing.assert_array_equal(whisper_output_lengths(pm.config, torch.from_numpy(LENS)).numpy(),
                                  np.asarray(jo.logit_lengths))
    np.testing.assert_allclose(float(po.loss), float(jo.loss), rtol=1e-5)
    _close(po.hidden_states[-1].numpy(), jo.hidden_states[-1])


def test_whisper_ctc_tree_round_trips():
    _, pm, tree, _ = _ctc_pair({"learnable_blank_head": True, "sub_sample": True})
    back = whisper_ctc_flax_tree_from_state_dict(pm.state_dict(), pm.config)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_learnable_blank_head_leaves_the_vocab_kernel_bit_equal():
    """The frozen vocabulary kernel is a buffer: the CTC loss reaches only the
    blank column, and three optimizer steps leave the kernel bit-equal, as the
    reference's frozen weight stays. The JAX optimizer moves it (ROADMAP.md
    reference caveat (l)): its stop-gradient zeroes the gradient, but
    ``optax.adamw``'s decay mask takes every 2-D parameter."""
    import optax

    from huggingface_asr_tpu.training.optim import OptimizerConfig as JOpt
    from huggingface_asr_tpu.training.optim import make_optimizer

    kernel = {"lm_head_frozen_kernel": jnp.ones((4, 4))}
    tx = make_optimizer(JOpt(learning_rate=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.1))
    updates, _ = tx.update({"lm_head_frozen_kernel": jnp.zeros((4, 4))}, tx.init(kernel), kernel)
    moved = optax.apply_updates(kernel, updates)["lm_head_frozen_kernel"]
    assert not np.array_equal(np.asarray(moved), np.ones((4, 4)))
    _, pm, _, x = _ctc_pair({"learnable_blank_head": True})
    frozen, blank = pm.lm_head_frozen_kernel.clone(), pm.blank_kernel.detach().clone()
    assert "lm_head_frozen_kernel" not in dict(pm.named_parameters())
    trainer = CTCTrainer(pm, TrainerConfig(spec_augment=None, max_grad_norm_guard=1e9), device="cpu",
                         dtype="float32")
    state = trainer.init_state()
    rng = np.random.default_rng(2)
    batch = {"input_features": x, "input_lengths": LENS, "labels": rng.integers(1, 20, (3, 4)).astype(np.int32),
             "label_lengths": np.array([4, 3, 2], np.int32)}
    for _ in range(3):
        state, metrics = trainer.train_step(state, batch)
        assert int(metrics["step_applied"]) == 1
    assert torch.equal(pm.lm_head_frozen_kernel, frozen)
    assert not torch.equal(pm.blank_kernel.detach(), blank)


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
