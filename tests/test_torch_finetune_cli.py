"""PyTorch port, fine-tuning from an SSL pretraining checkpoint through both CLIs, on the CPU.

- A JAX BEST-RQ ``final/`` (seeded values) is converted by
  ``export_jax_checkpoint.py`` and fine-tuned by the port's ``train_ctc
  --from_pretrained`` with both BEST-RQ adapters (``--config_overrides``): its
  encoder at step 0 equals the JAX CLI's graft bit for bit (and the
  checkpoint's), the adapters start one-hot / fresh, the pretraining entries
  are dropped; step 1 from the JAX CLI's whole initial state (its fresh head
  and adapters carried across) gives the JAX CLI's logged loss within 1e-5
  relative (every dropout 0, no SpecAugment, fp32).
- A wav2vec2 ``final/`` is refused by both CLIs: JAX's ``jax.tree.map`` finds
  ``masked_spec_embed`` in the checkpoint's encoder only (ROADMAP.md caveat
  (h)), and the port names it.

The corpus and tokenizer are those of ``tests/test_torch_aed_cli.py``
(utterances of 1.5-2 s, so that every label row has a CTC alignment).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.bestrq import BestRQForPreTraining as JBestRQ
from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.models.wav2vec2_ssl import Wav2Vec2ForPreTraining as JWav2Vec2
from huggingface_asr_tpu.training import loop as j_loop
from huggingface_asr_tpu.training.model_factory import save_params as j_save_params
from torch_port_helpers import randomize

from export_jax_checkpoint import export
from huggingface_asr_tpu_torch.cli import train_ctc as p_train_ctc
from huggingface_asr_tpu_torch.interop.from_jax import state_dict_from_flax
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.training import loop as p_loop
from huggingface_asr_tpu_torch.training.model_factory import STATE_FILE

datasets = pytest.importorskip("datasets")
pytest.importorskip("transformers")

TINY = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, conv_dim=(8, 8),
    conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1), vocab_size=30,
    best_rq_codebook_size=32, best_rq_codebook_dim=8, best_rq_num_books=1,
    num_codevectors_per_group=16, codevector_dim=16, proj_codevector_dim=16, num_negatives=4,
    hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, csgu_conv_dropout=0.0, final_dropout=0.0,
)
OVERRIDES = "finetune_with_layer_mixing=True;finetune_with_additional_layer=True"
WORDS = ["alpha", "beta", "gamma", "delta"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(root, dataset dir, tokenizer dir): 16 utterances of 1.5-2 s, so that
    every label row has a CTC alignment."""
    from huggingface_asr_tpu.cli.train_tokenizer import main as train_tokenizer

    root = tmp_path_factory.mktemp("finetune")
    rng = np.random.default_rng(1)
    rows = {"audio": [], "text": [], "input_len": []}
    for _ in range(16):
        n = int(rng.integers(24000, 32000))
        rows["audio"].append(rng.standard_normal(n).astype(np.float32) * 0.1)
        rows["text"].append(" ".join(rng.choice(WORDS, size=rng.integers(1, 4))))
        rows["input_len"].append(n / 16000.0)
    ds = datasets.Dataset.from_dict(rows)
    path = str(root / "ds")
    datasets.DatasetDict({"train": ds, "validation": ds.select(range(4)), "test": ds.select(range(4))}) \
        .save_to_disk(path)
    tok = str(root / "tok")
    train_tokenizer(["--dataset_name", path, "--load_from_disk", "--no-do_resample", "--tokenizer_type", "unigram",
                     "--vocab_size", "40", "--tokenizer_output_dir", tok])
    return root, path, tok


def _jax_final(root, name, jmodel, seed):
    """A JAX pretraining ``final/`` of ``jmodel`` with seeded values."""
    rng = np.random.default_rng(seed)
    feats, lens = jnp.zeros((1, 64, 80)), jnp.asarray([64])
    mask = jnp.asarray(rng.random((1, 16)) < 0.5)  # 16 encoder frames
    args = (feats, lens, mask) + ((jnp.zeros((1, 16, 4), jnp.int32),) if isinstance(jmodel, JWav2Vec2) else ())
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(0), "gumbel": jax.random.key(1),
                                                 "mask_noise": jax.random.key(1)}, *args))
    final = str(root / name / "final")
    os.makedirs(final)
    j_save_params(randomize(shapes["params"], rng), final, jmodel.config)
    return final


def _cli_args(path, tok, out, final):
    return ["--dataset_name", path, "--load_from_disk", "--no-do_resample", "--tokenizer_name", tok,
            "--from_pretrained", final, "--config_overrides", OVERRIDES, "--dtype", "float32", "--output_dir", out,
            "--per_device_train_batch_size", "8", "--per_device_eval_batch_size", "4", "--max_steps", "1",
            "--logging_steps", "1", "--eval_steps", "100", "--save_steps", "100", "--warmup_steps", "1",
            "--no-apply_spec_augment", "--max_duration_in_seconds", "3", "--pad_to_multiple", "25"]


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def grafted(corpus):
    """The JAX CLI's grafted initial state and step-1 loss, and the port CLI's
    step-0 state, first batch and step 1 from JAX's initial state."""
    from huggingface_asr_tpu.cli.train_ctc import main as j_train_ctc

    root, path, tok = corpus
    final = _jax_final(root, "bestrq", JBestRQ(JConfig(**TINY)), seed=3)
    port_final = str(root / "bestrq_port")
    assert export(final, port_final) == "bestrq"

    seen = {}
    real_fit = j_loop.CTCTrainer.fit

    def j_fit(self, state, *a, **k):
        seen["jax_init"] = jax.tree.map(np.asarray, state.params)
        real_fit(self, state, *a, **k)
        raise _Stop

    j_loop.CTCTrainer.fit = j_fit
    try:
        with pytest.raises(_Stop):
            j_train_ctc(_cli_args(path, tok, str(root / "jax_ft"), final))
    finally:
        j_loop.CTCTrainer.fit = real_fit
    with open(root / "jax_ft" / "metrics.jsonl") as f:
        seen["jax_loss"] = [r for r in map(json.loads, f) if "loss" in r][0]["loss"]

    def p_fit(self, state, train_iter, *a, **k):
        seen["port_init"] = {k_: v.clone() for k_, v in state.model.state_dict().items()}
        batch = next(iter(train_iter))
        state.model.load_state_dict(state_dict_from_flax(seen["jax_init"], state.model.config), strict=True)
        seen["port_step1"] = {k_: float(v) for k_, v in self.train_step(state, batch)[1].items()}
        raise _Stop

    real_p_fit = p_loop.CTCTrainer.fit
    p_loop.CTCTrainer.fit = p_fit
    try:
        with pytest.raises(_Stop):
            p_train_ctc.main(_cli_args(path, tok, str(root / "port_ft"), port_final) + ["--device", "cpu"])
    finally:
        p_loop.CTCTrainer.fit = real_p_fit
    seen["checkpoint"] = torch.load(os.path.join(port_final, STATE_FILE), weights_only=True)
    return seen


def test_the_port_grafts_the_encoder_bit_for_bit(grafted):
    cfg = EBranchformerConfig(**{**TINY, "finetune_with_layer_mixing": True,
                                 "finetune_with_additional_layer": True, "vocab_size": 40})
    want = state_dict_from_flax(grafted["jax_init"], cfg)
    got = grafted["port_init"]
    encoder = [k for k in want if k.startswith("wav2vec2.")]
    assert set(got) == set(want) and len(encoder) > 50
    for k in encoder:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], grafted["checkpoint"][k]), k
    assert torch.equal(got["per_layer_weights"], torch.tensor([0.0, 0.0, 1.0]))
    assert not any(k.startswith(("classifiers", "rpq")) for k in got)


def test_step_one_from_jax_initial_state_matches_the_jax_cli(grafted):
    p, j = grafted["port_step1"], grafted["jax_loss"]
    print(f"\nstep 1: port {p['loss']:.7f}, JAX CLI {j:.7f}")
    assert p["step_applied"] == 1 and abs(p["loss"] - j) <= 1e-5 * abs(j)


def test_both_clis_refuse_a_wav2vec2_checkpoint(corpus):
    from huggingface_asr_tpu.cli.train_ctc import main as j_train_ctc

    root, path, tok = corpus
    final = _jax_final(root, "wav2vec2", JWav2Vec2(JConfig(**TINY)), seed=4)
    port_final = str(root / "wav2vec2_port")
    assert export(final, port_final) == "wav2vec2"
    with pytest.raises(ValueError, match="masked_spec_embed"):
        j_train_ctc(_cli_args(path, tok, str(root / "jax_w2v"), final))
    with pytest.raises(ValueError, match="wav2vec2.masked_spec_embed"):
        p_train_ctc.main(_cli_args(path, tok, str(root / "port_w2v"), port_final) + ["--device", "cpu"])
