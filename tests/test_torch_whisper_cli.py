"""PyTorch port, ``train_aed --model_family whisper`` against the JAX CLI on the CPU.

A JAX initial state of a tiny Whisper seq2seq model (``model.init``, saved as
a JAX ``final/``) carried across by ``export_jax_checkpoint.py``; the JAX
CLI trains two steps from it (fp32, no SpecAugment) on a train-only corpus
(so that it compiles no final decode), the port's CLI two steps from the
converted state on the same train split with a test split: the step-1 loss
within 1e-5 relative and the gradient norm within 1e-4 of the JAX CLI's,
every step applied, and the test split decoded through ``generate_whisper``
with its predictions written. (Split from ``tests/test_torch_recipe_cli.py``
to keep each file near a minute on one worker.)
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from huggingface_asr_tpu_torch.cli import train_aed
from huggingface_asr_tpu_torch.training.model_factory import load_whisper_model

pytest.importorskip("datasets")
pytest.importorskip("transformers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from export_jax_checkpoint import export  # noqa: E402
from torch_port_helpers import RECIPE_TRAIN, logged, recipe_corpus  # noqa: E402

WHISPER = {"d_model": 32, "encoder_layers": 1, "encoder_attention_heads": 2, "encoder_ffn_dim": 64,
           "decoder_layers": 1, "decoder_attention_heads": 2, "decoder_ffn_dim": 64, "max_source_positions": 256,
           "max_target_positions": 64}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(root, train-only corpus, train + test corpus, tokenizer dir)."""
    return recipe_corpus(tmp_path_factory.mktemp("whisper_cli"), {})


def test_train_aed_whisper_step_one_matches_jax_from_one_state(corpus):
    from huggingface_asr_tpu.cli.common import load_tokenizer, tokenizer_ids
    from huggingface_asr_tpu.cli.train_aed import main as j_train_aed
    from huggingface_asr_tpu.models.whisper_seq2seq import WhisperForConditionalGeneration as JModel
    from huggingface_asr_tpu.models.whisper_seq2seq import WhisperSeq2SeqConfig as JConfig
    from huggingface_asr_tpu.training.model_factory import save_params

    root, train_only, with_test, tok = corpus
    ids = tokenizer_ids(load_tokenizer(tok))
    cfg = JConfig(**WHISPER, vocab_size=ids["vocab_size"], decoder_start_token_id=ids["bos"],
                  eos_token_id=ids["eos"], pad_token_id=ids["pad"])
    params = JModel(cfg).init(jax.random.key(7), jnp.zeros((1, 64, 80)), jnp.asarray([64]),
                              labels=jnp.zeros((1, 4), jnp.int32), label_lengths=jnp.asarray([4]))["params"]
    jax_init, port_init = str(root / "jax_whisper_init"), str(root / "port_whisper_init")
    os.makedirs(jax_init)
    save_params(jax.device_get(params), jax_init, cfg)
    assert export(jax_init, port_init) == "whisper"
    common = ["--tokenizer_name", tok, "--model_family", "whisper", *RECIPE_TRAIN, "--num_beams", "2",
              "--max_length", "8", "--num_candidates", "8"]
    j_out, p_out = str(root / "jax_whisper"), str(root / "port_whisper")
    j_train_aed(["--dataset_name", train_only, "--from_pretrained", jax_init, "--output_dir", j_out, *common])
    results = train_aed.main(["--dataset_name", with_test, "--from_pretrained", port_init, "--output_dir", p_out,
                              "--device", "cpu", *common])
    j_steps, p_steps = logged(j_out), logged(p_out)
    assert [r["step"] for r in p_steps] == [r["step"] for r in j_steps] == [1, 2]
    np.testing.assert_allclose(p_steps[0]["loss"], j_steps[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(p_steps[0]["grad_norm"], j_steps[0]["grad_norm"], rtol=1e-4)
    assert all(int(r["step_applied"]) == 1 for r in p_steps)
    assert list(results) == ["test"] and results["test"].num_examples == 4
    assert os.path.exists(os.path.join(p_out, "predictions_test.csv"))
    model = load_whisper_model(os.path.join(p_out, "final"), "cpu")
    assert model.config.vocab_size == ids["vocab_size"]
