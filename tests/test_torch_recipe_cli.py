"""PyTorch port, the recipe families' command-line surface against the JAX
package on the CPU.

The JAX CLI trains both ``train_ctc`` recipe families two steps (fp32, no SpecAugment) on a tiny
synthetic corpus, as ``tests/test_recipe_models_cli.py`` does, on a corpus
copy that holds the train split alone, so that no JAX run compiles a final
decode. Then:

- ``export_jax_checkpoint.py`` converts each ``final/``, and the port's
  ``evaluate`` writes byte-identical fp32 transcripts to the JAX
  ``evaluate``'s for ``whisper_ctc`` and ``llm_asr``;
- the port's ``train_ctc`` trains both ``train_ctc`` families from its own
  initialiser and writes ``final/`` and the test predictions
  (``tests/test_torch_recipe_cli_port.py``, on this file's corpus);
- ``--from_hf_checkpoint`` with ``--model_family whisper_ctc``: the JAX CLI
  trains from its own init as if the flag were absent (its run here passes a
  directory that does not exist), the port raises (ROADMAP.md reference
  caveat (i)).

The JAX CLIs run once each (module-scoped fixtures). The Whisper seq2seq
family's ``train_aed`` is held in ``tests/test_torch_whisper_cli.py``.
"""

import os
import sys

import pytest

from huggingface_asr_tpu_torch.cli import evaluate, train_ctc

datasets = pytest.importorskip("datasets")
pytest.importorskip("transformers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from export_jax_checkpoint import export  # noqa: E402
from torch_port_helpers import RECIPE_TRAIN as TRAIN, recipe_corpus  # noqa: E402

WHISPER_CTC = {"d_model": 32, "encoder_layers": 1, "encoder_attention_heads": 2, "encoder_ffn_dim": 64,
               "max_source_positions": 256, "llm_dim": 32, "additional_head_count": 2, "blank_token_id": 0}
LLM_ASR = {"encoder": WHISPER_CTC,
           "decoder": {"n_embd": 32, "n_layer": 1, "n_head": 2, "n_positions": 512, "add_cross_attention": False,
                       "resid_pdrop": 0.0, "embd_pdrop": 0.0, "attn_pdrop": 0.0},
           "number_of_prompt_tokens": 4, "ctc_weight": 0.3}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(root, train-only corpus, train + test corpus, tokenizer dir)."""
    return recipe_corpus(tmp_path_factory.mktemp("recipe_cli"), {"whisper_ctc": WHISPER_CTC, "llm_asr": LLM_ASR})


def _same_bytes(a, b, name):
    with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
        return fa.read() == fb.read()


@pytest.fixture(scope="module")
def jax_trained(corpus):
    """family -> the port model directory converted from the JAX CLI's ``final/``."""
    from huggingface_asr_tpu.cli.train_ctc import main as j_train_ctc

    root, train_only, _, tok = corpus
    out = {}
    for family, extra in (("whisper_ctc", ["--from_hf_checkpoint", str(root / "no_such_whisper")]),
                          ("llm_asr", [])):
        j_out = str(root / f"jax_{family}")
        j_train_ctc(["--dataset_name", train_only, "--tokenizer_name", tok, "--model_family", family,
                     "--model_config", str(root / f"{family}.json"), "--output_dir", j_out, *TRAIN, *extra])
        port_dir = str(root / f"port_{family}")
        assert export(os.path.join(j_out, "final"), port_dir) == family
        out[family] = (os.path.join(j_out, "final"), port_dir)
    return out


@pytest.mark.parametrize("family,extra", [("whisper_ctc", []), ("llm_asr", ["--max_length", "8"])])
def test_evaluate_transcripts_are_byte_identical_to_jax(jax_trained, corpus, family, extra):
    from huggingface_asr_tpu.cli.evaluate import main as j_evaluate

    root, _, with_test, tok = corpus
    jax_dir, port_dir = jax_trained[family]
    common = ["--dataset_name", with_test, "--load_from_disk", "--no-do_resample", "--preprocessing_num_workers",
              "1", "--tokenizer_name", tok, "--model_type", family, "--dtype", "float32", "--batch_size", "4", *extra]
    j_out, p_out = str(root / f"jax_eval_{family}"), str(root / f"port_eval_{family}")
    j_evaluate([*common, "--from_pretrained", jax_dir, "--output_dir", j_out])
    evaluate.main([*common, "--from_pretrained", port_dir, "--output_dir", p_out, "--device", "cpu"])
    for name in ("predictions_test.csv", "predictions_test_hyp.trn"):
        assert _same_bytes(j_out, p_out, name), name
    with open(os.path.join(p_out, "predictions_test_hyp.trn")) as f:
        assert any(line.split("(")[0].strip() for line in f)  # not every transcript is empty


def test_whisper_ctc_from_hf_checkpoint_raises_in_the_port(corpus):
    """Caveat (i): the JAX run of ``jax_trained`` took the same flag and trained."""
    root, _, with_test, tok = corpus
    with pytest.raises(ValueError, match="from_hf_checkpoint.*whisper_ctc"):
        train_ctc.main(["--dataset_name", with_test, "--tokenizer_name", tok, "--model_family", "whisper_ctc",
                        "--model_config", str(root / "whisper_ctc.json"), "--from_hf_checkpoint",
                        "openai/whisper-small.en", "--output_dir", str(root / "refused"), "--device", "cpu", *TRAIN])


def test_the_jax_cli_ignores_from_hf_checkpoint_for_whisper_ctc(jax_trained, corpus):
    """The JAX run passed ``--from_hf_checkpoint`` naming a directory that
    does not exist and wrote its ``final/`` all the same."""
    root = corpus[0]
    assert not os.path.exists(root / "no_such_whisper")
    assert os.path.exists(os.path.join(jax_trained["whisper_ctc"][0], "config.json"))


def test_the_recipe_modules_need_neither_jax_nor_transformers():
    """With ``jax``, ``flax``, ``datasets``, ``transformers`` and the JAX
    package blocked (the card's machine has none of them), the recipe
    modules import and the smoke run's recipe phase is there."""
    import subprocess

    blocked = ("jax", "flax", "optax", "datasets", "transformers", "huggingface_asr_tpu")
    code = ("import sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import huggingface_asr_tpu_torch.models.whisper_ctc, huggingface_asr_tpu_torch.models.whisper_seq2seq\n"
            "import huggingface_asr_tpu_torch.models.llm_asr, huggingface_asr_tpu_torch.interop.hf_whisper\n"
            "import huggingface_asr_tpu_torch.utils.vocab_subset, huggingface_asr_tpu_torch.decoding.generate as g\n"
            "import huggingface_asr_tpu_torch.cli.train_aed as a, chip_smoke\n"
            "assert callable(g.generate_whisper) and callable(a.run_whisper) and callable(chip_smoke.recipe_phase)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
