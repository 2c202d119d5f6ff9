"""PyTorch port, the Whisper recipe models against the JAX package on the CPU.

``WhisperEncoderForCTC`` (plain head, ``learnable_blank_head``, ``sub_sample``)
takes one seeded numpy parameter tree on both sides (the port's through the
``from_jax`` tables); the seq2seq model, ``generate_whisper`` and the
``transformers`` checkpoints are in ``tests/test_torch_whisper_seq2seq.py``.
Everything is fp32. Tolerances: logits within 1e-5 of their largest
magnitude, losses within 1e-5 relative, beam scores within 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.whisper_ctc import WhisperCTCConfig as JCTCConfig
from huggingface_asr_tpu.models.whisper_ctc import WhisperEncoderForCTC as JCTC

from huggingface_asr_tpu_torch.interop.from_jax import (
    whisper_ctc_flax_tree_from_state_dict,
    whisper_ctc_state_dict_from_flax,
)
from huggingface_asr_tpu_torch.models.whisper_ctc import (
    WhisperCTCConfig,
    WhisperEncoderForCTC,
    whisper_output_lengths,
)
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
