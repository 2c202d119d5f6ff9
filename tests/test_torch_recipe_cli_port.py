"""PyTorch port, the recipe families' ``train_ctc``: the port trains both
families from its own initialiser on the corpus of
``tests/test_torch_recipe_cli.py`` (split from it, whose corpus fixture
these tests share, so that the two files run on two workers) and writes
``final/`` and the test predictions.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_recipe_cli import corpus  # noqa: F401  (fixture)
from torch_port_helpers import RECIPE_TRAIN as TRAIN, logged as _logged

from huggingface_asr_tpu_torch.cli import train_ctc
from huggingface_asr_tpu_torch.training.model_factory import load_llm_asr_model, load_whisper_ctc_model


@pytest.mark.parametrize("family,load", [("whisper_ctc", load_whisper_ctc_model), ("llm_asr", load_llm_asr_model)])
def test_the_port_trains_both_train_ctc_families_from_its_own_init(corpus, family, load):
    root, _, with_test, tok = corpus
    out = str(root / f"port_trained_{family}")
    results = train_ctc.main(["--dataset_name", with_test, "--tokenizer_name", tok, "--model_family", family,
                              "--model_config", str(root / f"{family}.json"), "--output_dir", out, "--device", "cpu",
                              *TRAIN])
    steps = _logged(out)
    assert [r["step"] for r in steps] == [1, 2] and all(np.isfinite(r["loss"]) for r in steps)
    assert ("enc_loss" in steps[0]) == (family == "llm_asr")
    assert np.isfinite(results["test"].metrics["wer"])
    assert os.path.exists(os.path.join(out, "predictions_test.csv"))
    model = load(os.path.join(out, "final"), "cpu")
    assert isinstance(model, torch.nn.Module)
