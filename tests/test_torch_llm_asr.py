"""PyTorch port, LLM-ASR against the JAX package on the CPU.

One seeded numpy parameter tree on both sides (the port's through
``llm_asr_state_dict_from_flax``), both prompting variants: the token plan
and the surviving-frame counts equal (the batch's rows keep different counts
after the CTC dedup), the LLM logits within 1e-5 of their largest magnitude,
the loss within 1e-5 relative (``llm_asr_greedy_decode`` against JAX's in
``tests/test_torch_llm_asr_decode.py``). ``freeze_asr`` zeroes the encoder's gradients on both
sides, and ``freeze_llm`` changes no gradient on either (ROADMAP.md reference
caveat (j): the JAX model leaves freezing to an optimizer mask no CLI
builds). The port's ``utils/vocab_subset.py`` is held against the original.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
from huggingface_asr_tpu.models.llm_asr import LLMASRConfig as JConfig
from huggingface_asr_tpu.models.llm_asr import LLMASRModel as JModel
from huggingface_asr_tpu.models.whisper_ctc import WhisperCTCConfig as JEnc
from huggingface_asr_tpu.utils import vocab_subset as j_vocab_subset

from huggingface_asr_tpu_torch.interop.from_jax import llm_asr_flax_tree_from_state_dict, llm_asr_state_dict_from_flax
from huggingface_asr_tpu_torch.models.llm_asr import LLMASRConfig, LLMASRModel
from huggingface_asr_tpu_torch.utils import vocab_subset
from torch_port_helpers import randomize

ENC = dict(d_model=32, encoder_layers=1, encoder_attention_heads=4, encoder_ffn_dim=64, max_source_positions=64,
           llm_dim=24, additional_head_count=2, vocab_size=6)
DEC = dict(vocab_size=30, n_embd=16, n_layer=2, n_head=2, n_positions=128, add_cross_attention=False,
           resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=3)
LENS = np.array([100, 77, 41], np.int32)
LABEL_LENGTHS = np.array([5, 3, 2], np.int32)
VARIANTS = pytest.mark.parametrize("tokens", [False, True], ids=["frames", "tokens"])


def _pair(tokens: bool, **extra):
    d = {"encoder": ENC, "decoder": DEC, "number_of_prompt_tokens": 3, "ctc_weight": 0.3,
         "prompt_with_tokens": tokens, **extra}
    jcfg = JConfig(encoder=JEnc(**ENC), decoder=JDec(**DEC), **{k: v for k, v in d.items()
                                                                 if k not in ("encoder", "decoder")})
    pcfg = LLMASRConfig.from_dict(d)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 100, 80)).astype(np.float32)
    labels = rng.integers(4, 6, (3, 5)).astype(np.int32)
    jm = JModel(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(LENS),
                                            labels=jnp.asarray(labels),
                                            label_lengths=jnp.asarray(LABEL_LENGTHS)))["params"]
    tree = randomize(shapes, rng)
    pm = LLMASRModel(pcfg)
    pm.load_state_dict(llm_asr_state_dict_from_flax(tree, pcfg), strict=True)
    return jm, pm, tree, x, labels


def _close(port, ref, scale_tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=0, atol=scale_tol * np.abs(ref).max())


@VARIANTS
def test_token_plan_lengths_logits_and_loss_match_jax(tokens):
    jm, pm, tree, x, labels = _pair(tokens)
    jo = jm.apply({"params": tree}, jnp.asarray(x), jnp.asarray(LENS), labels=jnp.asarray(labels),
                  label_lengths=jnp.asarray(LABEL_LENGTHS))
    with torch.no_grad():
        po = pm(torch.from_numpy(x), torch.from_numpy(LENS), torch.from_numpy(labels),
                torch.from_numpy(LABEL_LENGTHS))
    np.testing.assert_array_equal(po.token_plan.numpy(), np.asarray(jo.token_plan))
    np.testing.assert_array_equal(po.asr_lengths.numpy(), np.asarray(jo.asr_lengths))
    assert len(set(po.asr_lengths.tolist())) == 3  # the dedup keeps a different count in each row
    _close(po.llm_logits.numpy(), jo.llm_logits)
    _close(po.encoder_logits.numpy(), jo.encoder_logits)
    np.testing.assert_allclose(float(po.loss), float(jo.loss), rtol=1e-5)
    np.testing.assert_allclose(float(po.enc_loss), float(jo.enc_loss), rtol=1e-5)


def _grads(jm, pm, tree, x, labels):
    """(JAX gradient tree, the port's gradients as a Flax tree)."""
    def loss_fn(params):
        return jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(LENS), labels=jnp.asarray(labels),
                        label_lengths=jnp.asarray(LABEL_LENGTHS)).loss

    j_grads = jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, tree))
    pm.zero_grad()
    out = pm(torch.from_numpy(x), torch.from_numpy(LENS), torch.from_numpy(labels), torch.from_numpy(LABEL_LENGTHS))
    out.loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in pm.named_parameters()}
    return j_grads, llm_asr_flax_tree_from_state_dict(grads, pm.config)


def _max_abs(tree):
    return max(float(np.abs(np.asarray(v)).max()) for v in jax.tree.leaves(tree))


def test_freeze_asr_gives_zero_encoder_gradients_on_both_sides():
    jm, pm, tree, x, labels = _pair(False, freeze_asr=True, ctc_weight=0.0)
    j_grads, p_grads = _grads(jm, pm, tree, x, labels)
    assert _max_abs(j_grads["encoder"]) == 0.0 and _max_abs(p_grads["encoder"]) == 0.0
    assert _max_abs(j_grads["linear"]) > 0.0
    jax.tree.map(lambda p, j: _close(p, j, 1e-4), p_grads, j_grads)


def test_freeze_llm_changes_no_gradient_on_both_sides():
    """Caveat (j): with ``freeze_llm`` the decoder's gradients are the
    unfrozen model's on both sides."""
    jm, pm, tree, x, labels = _pair(False, freeze_llm=True)
    j_frozen, p_frozen = _grads(jm, pm, tree, x, labels)
    jm_u, pm_u, _, _, _ = _pair(False)
    j_open, p_open = _grads(jm_u, pm_u, tree, x, labels)
    jax.tree.map(np.testing.assert_array_equal, j_frozen, j_open)
    jax.tree.map(np.testing.assert_array_equal, p_frozen, p_open)
    assert _max_abs(p_frozen["decoder"]) > 0.0
    jax.tree.map(lambda p, j: _close(p, j, 1e-4), p_frozen, j_frozen)


class _Tok:
    all_special_tokens = ["<s>", "</s>"]
    _pieces = ["<s>", "</s>", "a", "B", "hello", "é", " ", "42", "Ωx", "x!"]

    def __len__(self):
        return len(self._pieces)

    def decode(self, i):
        return self._pieces[i]


def test_vocab_subset_copy_equals_the_original():
    tok = _Tok()
    ours, theirs = vocab_subset.get_token_subset(tok), j_vocab_subset.get_token_subset(tok)
    assert ours == theirs
    mapping = ours[0]
    kernel = np.random.default_rng(0).standard_normal((4, len(tok))).astype(np.float32)
    np.testing.assert_array_equal(vocab_subset.subset_lm_head(kernel, mapping),
                                  j_vocab_subset.subset_lm_head(kernel, mapping))
    ids = [0, 3, 2, 5, 9, 4]
    assert vocab_subset.map_ids(ids, mapping) == j_vocab_subset.map_ids(ids, mapping)
