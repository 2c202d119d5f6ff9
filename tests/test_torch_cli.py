"""PyTorch port, the CTC command-line surface against the JAX package's: the
values the port cannot honour yet raise, naming their ROADMAP.md item;
``evaluate.run`` on an in-memory split; the CLI modules import without JAX,
``datasets`` or ``transformers``; an encoder-only checkpoint is grafted
under a fresh head. The CLIs' runs against the JAX CLIs' outputs (train_ctc,
evaluate for a CTC and a joint model) are in ``tests/test_torch_cli_runs.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from huggingface_asr_tpu_torch.cli import evaluate as p_evaluate
from huggingface_asr_tpu_torch.cli import train_ctc as p_train_ctc
from huggingface_asr_tpu_torch.data.datasets import ColumnTable
from huggingface_asr_tpu_torch.training.model_factory import load_state

datasets = pytest.importorskip("datasets")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Tok:
    bos_token_id, eos_token_id, pad_token_id, unk_token_id = 0, 1, 3, 2

    def __len__(self):
        return 40

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))


GATE_DIR = os.path.join(REPO, "huggingface_asr_tpu_torch", "assets", "gate_ctc")


@pytest.mark.parametrize("cli,argv,error,words", [
    ("train", ["--model_family", "whisper_ctc", "--from_hf_checkpoint", "x", "--device", "cpu"], ValueError,
     "caveat .i."),
    ("train", ["--model_family", "llm_asr", "--from_hf_checkpoint", "x", "--device", "cpu"], ValueError,
     "caveat .i."),
    ("train", ["--fsdp"], RuntimeError, "CUDA is not available"),
    ("train", ["--profile_steps", "3"], ValueError, "profile_steps.*caveat .m."),
    ("eval", ["--model_type", "whisper"], ValueError, "whisper_ctc or llm_asr"),
    ("eval", ["--model_type", "llm_asr", "--fused_encoder", "on", "--device", "cpu"], ValueError, "CUDA"),
    ("eval", ["--fused_encoder", "on", "--device", "cpu"], ValueError, "CUDA"),
    ("eval", ["--fused_encoder", "on", "--device", "cpu", "--dtype", "float32"], ValueError, "bfloat16"),
    ("eval", [], RuntimeError, "CUDA is not available"),
])
def test_what_the_port_cannot_honour_yet_raises(cli, argv, error, words, tmp_path):
    """Each refusal names its field, its ROADMAP.md item or the reference
    caveat behind it (``run`` takes the parsed groups, a dataset mapping and
    a tokenizer)."""
    from huggingface_asr_tpu_torch.data.datasets import DataConfig
    from huggingface_asr_tpu_torch.training.arguments import (
        GeneralTrainingArguments,
        GenerationArguments,
        ModelArguments,
    )
    from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser

    if torch.cuda.is_available() and error is RuntimeError:
        pytest.skip("the default device exists here")
    dataset = {"test": ColumnTable({"audio": [np.zeros(1600, np.float32)], "text": ["a"], "input_len": [0.1]})}
    if cli == "train":
        groups = [ModelArguments, GeneralTrainingArguments, GenerationArguments, DataConfig]
        args = DataclassArgumentParser(groups).parse_args_into_dataclasses(argv + ["--output_dir", str(tmp_path)])
        with pytest.raises(error, match=words):
            p_train_ctc.run(*args, dataset, _Tok())
    else:
        groups = [p_evaluate.EvalArguments, ModelArguments, GenerationArguments, DataConfig]
        args = DataclassArgumentParser(groups).parse_args_into_dataclasses(
            argv + ["--from_pretrained", GATE_DIR, "--output_dir", str(tmp_path)])
        with pytest.raises(error, match=words):
            p_evaluate.run(*args, dataset, _Tok())


def test_evaluate_runs_on_a_column_table_without_datasets(tmp_path):
    """``run`` on an in-memory split (what the card's smoke run passes): the
    plain route on the CPU writes the CSV and ``.trn`` files."""
    from huggingface_asr_tpu_torch.data.synthetic_speech import corpus_rows
    from huggingface_asr_tpu_torch.data.datasets import DataConfig
    from huggingface_asr_tpu_torch.training.arguments import GenerationArguments, ModelArguments

    rows = corpus_rows(n_train=0, n_eval=5, seed=3)
    results = p_evaluate.run(p_evaluate.EvalArguments(output_dir=str(tmp_path), batch_size=2),
                             ModelArguments(from_pretrained=GATE_DIR, device="cpu", dtype="float32"),
                             GenerationArguments(), DataConfig(),
                             {"test": ColumnTable(rows["test"])}, _Tok())
    assert list(results) == ["test"] and results["test"].num_examples == 5
    for suffix in (".csv", "_hyp.trn", "_ref.trn"):
        assert os.path.exists(tmp_path / f"predictions_test{suffix}")


def test_the_cli_modules_need_neither_jax_nor_datasets_nor_transformers():
    """Imported with ``jax``, ``flax``, ``datasets``, ``transformers`` and the
    JAX package blocked (the card's machine has none of them), the CLIs'
    ``run`` functions and the smoke run's phase are there."""
    import subprocess

    blocked = ("jax", "flax", "optax", "datasets", "transformers", "huggingface_asr_tpu")
    code = ("import sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import huggingface_asr_tpu_torch.cli.train_ctc as t, huggingface_asr_tpu_torch.cli.evaluate as e\n"
            "import huggingface_asr_tpu_torch.utils.normalizer, huggingface_asr_tpu_torch.data.preprocessing_config\n"
            "import huggingface_asr_tpu_torch.cli.pretrain as p, huggingface_asr_tpu_torch.models.wav2vec2_ssl\n"
            "import chip_smoke\n"
            "assert callable(t.run) and callable(e.run) and callable(p.run)\n"
            "assert callable(chip_smoke.cli_phase) and callable(chip_smoke.ssl_phase)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_an_encoder_only_checkpoint_is_grafted_under_a_fresh_head(tmp_path, monkeypatch):
    """A checkpoint without the CTC head (what SSL pretraining writes): the
    encoder comes from it bit for bit, the head from the initialiser, and the
    run trains (``tests/test_torch_finetune_cli.py`` holds it against JAX)."""
    import shutil

    from huggingface_asr_tpu_torch.data.datasets import DataConfig
    from huggingface_asr_tpu_torch.training import loop
    from huggingface_asr_tpu_torch.training.arguments import (
        GeneralTrainingArguments,
        GenerationArguments,
        ModelArguments,
    )

    src = tmp_path / "encoder_only"
    src.mkdir()
    shutil.copy(os.path.join(GATE_DIR, "config.json"), src / "config.json")
    encoder = {k: v for k, v in load_state(GATE_DIR).items() if k.startswith("wav2vec2.")}
    torch.save(encoder, src / "pytorch_model.bin")
    seen = {}
    real_fit = loop.CTCTrainer.fit

    def fit(self, state, *a, **k):
        seen.update({n: v.clone() for n, v in state.model.state_dict().items()})
        return real_fit(self, state, *a, **k)

    monkeypatch.setattr(loop.CTCTrainer, "fit", fit)

    class Tok(_Tok):
        def encode(self, text):
            return [4 + ord(c) % 30 for c in text if c != " "]

    audio = [np.random.default_rng(i).standard_normal(12000).astype(np.float32) * 0.1 for i in range(2)]
    dataset = {"train": ColumnTable({"audio": audio, "text": ["a b", "c"], "input_len": [0.75, 0.75]})}
    p_train_ctc.run(ModelArguments(from_pretrained=str(src), device="cpu", dtype="float32"),
                    GeneralTrainingArguments(output_dir=str(tmp_path / "out"), per_device_train_batch_size=2,
                                             max_steps=1, logging_steps=1, save_steps=10, warmup_steps=1),
                    GenerationArguments(), DataConfig(), dataset, Tok())
    assert all(torch.equal(seen[k], v) for k, v in encoder.items())
    assert seen["lm_head.weight"].shape[0] == len(_Tok()) and not torch.equal(
        seen["lm_head.weight"], load_state(GATE_DIR)["lm_head.weight"][:len(_Tok())])
    assert os.path.exists(tmp_path / "out" / "final" / "pytorch_model.bin")