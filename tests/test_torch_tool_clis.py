"""The port's tool CLIs against the JAX package's: ``train_tokenizer``,
``init_model_configs`` and the publisher (``interop/publish.py::
build_hub_repo``), on one seeded corpus and one set of weights.
``compute_dataset_statistics`` and ``cli/publish_model.py`` are in
``tests/test_torch_stats_cli.py``, on the same corpus and weights."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.cli import init_model_configs as j_configs
from huggingface_asr_tpu.cli import train_tokenizer as j_tokenizer
from huggingface_asr_tpu.interop import publish as j_publish
from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel
from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig as JJoint
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder as JJointModel
from huggingface_asr_tpu.training.model_factory import save_params as j_save_params

from huggingface_asr_tpu_torch.cli import init_model_configs as p_configs
from huggingface_asr_tpu_torch.cli import train_tokenizer as p_tokenizer
from huggingface_asr_tpu_torch.interop import publish as p_publish

WORDS = ["hello", "world", "speech", "model", "test", "data", "token", "audio"]
DATA_ARGS = ["--load_from_disk", "--no-do_resample", "--preprocessing_num_workers", "1"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Twelve seeded utterances of 0.5-2 s (a train split of ten, a test split
    of two), saved to disk, and a 48-piece unigram tokenizer trained on them
    by the JAX CLI."""
    import datasets

    root = tmp_path_factory.mktemp("tool_corpus")
    rng = np.random.default_rng(11)
    rows = {"audio": [], "text": [], "input_len": []}
    for _ in range(12):
        n = int(rng.integers(8000, 32000))
        t = np.arange(n) / 16000.0
        wav = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 800) * t) + 0.05 * rng.standard_normal(n)
        rows["audio"].append(wav.astype(np.float32))
        rows["text"].append(" ".join(rng.choice(WORDS, size=int(rng.integers(2, 6)))))
        rows["input_len"].append(n / 16000.0)
    ds = datasets.Dataset.from_dict(rows)
    path = str(root / "corpus")
    datasets.DatasetDict({"train": ds.select(range(10)), "test": ds.select(range(10, 12))}).save_to_disk(path)
    return path, rows


def _tokenizer_args(out):
    return ["--tokenizer_type", "unigram", "--vocab_size", "48", "--tokenizer_output_dir", out]


@pytest.fixture(scope="module")
def tokenizers(corpus, tmp_path_factory):
    path, _ = corpus
    root = tmp_path_factory.mktemp("tokenizers")
    extra = root / "extra.txt"
    extra.write_text("an extra line of text\n\nmore words here\n")
    outs = {}
    for name, main in (("jax", j_tokenizer.main), ("port", p_tokenizer.main)):
        outs[name] = str(root / name)
        main(["--dataset_name", path, *DATA_ARGS, *_tokenizer_args(outs[name]),
              "--additional_raw_text_files", str(extra)])
    return outs


def test_train_tokenizer_writes_the_same_tokenizer(tokenizers):
    """``tokenizer.json`` equal but for the order of pieces of equal
    frequency: HF ``tokenizers``' unigram trainer orders them by a hash map's
    iteration and steps their scores apart by 1e-4 in that order, which
    differs between two runs of one CLI in one process (as do the scores' last
    digits, by up to 4e-11 here: its EM sums run on threads). So: the same
    pieces, the same sorted scores within 1e-9, each piece's score within
    1e-3, the other
    sections byte-equal once serialized; the special-token files
    byte-identical."""
    with open(os.path.join(tokenizers["jax"], "tokenizer.json")) as a, \
            open(os.path.join(tokenizers["port"], "tokenizer.json")) as b:
        ref, got = json.load(a), json.load(b)
    ref_vocab, got_vocab = dict(ref["model"]["vocab"]), dict(got["model"]["vocab"])
    assert set(got_vocab) == set(ref_vocab) and len(ref_vocab) > 10
    np.testing.assert_allclose(sorted(got_vocab.values()), sorted(ref_vocab.values()), rtol=1e-9)
    assert all(abs(got_vocab[p] - ref_vocab[p]) <= 1e-3 for p in ref_vocab)
    assert [p for p, _ in got["model"]["vocab"][:5]] == [p for p, _ in ref["model"]["vocab"][:5]]  # the specials
    for key in ref:
        if key != "model":
            assert json.dumps(got[key]) == json.dumps(ref[key]), key
    assert {k: v for k, v in got["model"].items() if k != "vocab"} == {k: v for k, v in ref["model"].items()
                                                                        if k != "vocab"}
    for name in ("special_tokens_map.json", "tokenizer_config.json"):
        with open(os.path.join(tokenizers["jax"], name), "rb") as a, open(os.path.join(tokenizers["port"], name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("only", ["", "ebranchformer_small_ctc,decred_base"])
def test_init_model_configs_writes_equal_json(only, tmp_path):
    outs = {}
    for name, main in (("jax", j_configs.main), ("port", p_configs.main)):
        outs[name] = tmp_path / name
        args = ["--configs_output_dir", str(outs[name])] + (["--only", only] if only else [])
        main(args)
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"])) and len(names) == (2 if only else len(j_configs.CONFIGS))
    for n in names:
        assert json.loads((outs["port"] / n).read_text()) == json.loads((outs["jax"] / n).read_text())


# ---- publishing

ENC = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, conv_dim=(32, 32),
           conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1), vocab_size=50)
DEC = dict(vocab_size=50, n_positions=64, n_embd=32, n_layer=2, n_head=2, head_locations=(1,), head_weights=(0.3, 0.7))


def _jax_final(kind, root):
    """A JAX ``final/`` (orbax params + config.json) and its port twin from
    ``export_jax_checkpoint.py``."""
    from export_jax_checkpoint import export

    feats, lens = jnp.zeros((1, 40, 80), jnp.float32), jnp.asarray([40], jnp.int32)
    if kind == "joint":
        cfg = JJoint(encoder=JConfig(**ENC), decoder=JDec(**DEC), ctc_weight=0.3)
        params = JJointModel(cfg).init(jax.random.key(1), feats, lens, labels=jnp.zeros((1, 4), jnp.int32),
                                       label_lengths=jnp.asarray([4], jnp.int32))["params"]
    else:
        cfg = JConfig(**ENC)
        params = JModel(cfg, dtype=jnp.float32).init(jax.random.key(0), feats, lens)["params"]
    j_final, p_final = str(root / "jax_final"), str(root / "port_final")
    j_save_params(params, j_final, config=cfg)
    export(j_final, p_final)
    return j_final, p_final


def _card_metadata(path):
    text = open(os.path.join(path, "README.md")).read()
    assert text.startswith("---\n")
    return text.split("---\n")[1]


@pytest.mark.parametrize("kind", ["ctc", "joint"])
def test_build_hub_repo_matches_jax(kind, tokenizers, tmp_path):
    j_final, p_final = _jax_final(kind, tmp_path)
    kw = dict(model_type=kind, tokenizer_dir=tokenizers["jax"], repo_name="user/tiny", run_url="https://wandb.ai/r/1",
              extra_metrics={"wer": 0.5})
    j_out = j_publish.build_hub_repo(j_final, str(tmp_path / "jax_repo"), **kw)
    p_out = p_publish.build_hub_repo(p_final, str(tmp_path / "port_repo"), **kw)
    for name in ("config.json", "preprocessor_config.json"):
        with open(os.path.join(j_out, name)) as a, open(os.path.join(p_out, name)) as b:
            assert json.load(b) == json.load(a), name
    files = sorted(set(os.listdir(j_out)) - {"README.md", "pytorch_model.bin", "config.json",
                                             "preprocessor_config.json"})
    assert files and files == sorted(set(os.listdir(p_out)) - {"README.md", "pytorch_model.bin", "config.json",
                                                               "preprocessor_config.json"})
    for name in files:
        with open(os.path.join(j_out, name), "rb") as a, open(os.path.join(p_out, name), "rb") as b:
            assert a.read() == b.read(), name
    assert _card_metadata(p_out) == _card_metadata(j_out)
    card = open(os.path.join(p_out, "README.md")).read()
    assert "PyTorch/CUDA port" in card and "TPU-native" not in card
    assert "### Wandb run\nhttps://wandb.ai/r/1" in card and '"wer": 0.5' in card
    j_sd = torch.load(os.path.join(j_out, "pytorch_model.bin"), weights_only=True)
    p_sd = torch.load(os.path.join(p_out, "pytorch_model.bin"), weights_only=True)
    assert set(p_sd) == set(j_sd)
    for k, v in j_sd.items():
        assert p_sd[k].dtype == v.dtype and torch.equal(p_sd[k], v), k
