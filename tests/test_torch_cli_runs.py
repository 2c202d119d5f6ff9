"""PyTorch port, the CTC command-line surface against the JAX package's: the
CLIs' runs (split from ``tests/test_torch_cli.py`` so that the two files run
on two workers).

- The port's ``cli/train_ctc.py`` trains a tiny model a few steps on the CPU
  (the corpus and flags of ``tests/test_cli_e2e.py``, ``--device cpu``). Its
  ``final/`` loads into the JAX model through ``flax_tree_from_state_dict``,
  and the JAX model's fp32 logits equal the port's on the same features
  (relative 1e-4); ``load_ctc_model`` and ``ASRPipeline(model_type="ctc")``
  load it too.
- Both packages' ``cli/evaluate.py`` write the same artifacts: for a CTC model
  (the port-trained one, converted to orbax for JAX) the CSV and ``.trn``
  files byte for byte; for a seeded joint CTC/attention model (written by the
  JAX package, converted by ``export_jax_checkpoint.py``) with ``--save_nbest``
  also the n-best hypotheses byte for byte and the n-best score files within
  1e-4 absolute and 1e-6 relative (fp32 sums in another order; the files round
  to 1e-6, and a dead hypothesis scores near -1e9 x its weights).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel
from huggingface_asr_tpu.ops.features import LogMelConfig, LogMelFrontEnd
from torch_port_helpers import randomize

from huggingface_asr_tpu_torch.cli import evaluate as p_evaluate
from huggingface_asr_tpu_torch.cli import train_ctc as p_train_ctc
from huggingface_asr_tpu_torch.interop.from_jax import flax_tree_from_state_dict
from huggingface_asr_tpu_torch.training.model_factory import load_config, load_ctc_model, load_state

datasets = pytest.importorskip("datasets")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["hello", "world", "speech", "model", "test", "data"]
MODEL_CFG = {
    "hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 2,
    "intermediate_size": 64, "conv_dim": [8, 8], "conv_kernel": [3, 3],
    "conv_stride": [2, 2], "conv_padding": [1, 1],
    "hidden_dropout": 0.0, "attention_dropout": 0.0,
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(corpus dir, tokenizer dir, waveforms) of ``tests/test_cli_e2e.py``'s tiny corpus."""
    from huggingface_asr_tpu.cli.train_tokenizer import main as train_tokenizer

    root = tmp_path_factory.mktemp("cli_corpus")
    rng = np.random.default_rng(0)
    rows = {"audio": [], "text": [], "input_len": []}
    for _ in range(24):
        n = int(rng.integers(4000, 8000))
        rows["audio"].append(rng.standard_normal(n).astype(np.float32) * 0.1)
        rows["text"].append(" ".join(rng.choice(WORDS, size=rng.integers(2, 5))))
        rows["input_len"].append(n / 16000.0)
    ds = datasets.Dataset.from_dict(rows)
    path = str(root / "ds")
    datasets.DatasetDict({"train": ds, "validation": ds.select(range(4)), "test": ds.select(range(4))}) \
        .save_to_disk(path)
    tok = str(root / "tok")
    train_tokenizer(["--dataset_name", path, "--load_from_disk", "--no-do_resample", "--tokenizer_type", "unigram",
                     "--vocab_size", "64", "--tokenizer_output_dir", tok])
    return path, tok, rows["audio"]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """The output directory of the port's train_ctc (4 steps, as test_cli_e2e trains JAX's)."""
    path, tok, _ = corpus
    root = tmp_path_factory.mktemp("port_train")
    (root / "model.json").write_text(json.dumps(MODEL_CFG))
    out = str(root / "out")
    results = p_train_ctc.main([
        "--dataset_name", path, "--load_from_disk", "--no-do_resample", "--tokenizer_name", tok,
        "--model_config", str(root / "model.json"), "--dtype", "float32", "--output_dir", out,
        "--per_device_train_batch_size", "8", "--per_device_eval_batch_size", "4", "--max_steps", "4",
        "--logging_steps", "2", "--eval_steps", "3", "--save_steps", "4", "--warmup_steps", "2",
        "--max_duration_in_seconds", "2", "--pad_to_multiple", "25", "--device", "cpu",
    ])
    assert "test" in results and np.isfinite(results["test"].metrics["wer"])
    return out


def test_train_ctc_writes_the_jax_cli_outputs(trained):
    for name in ("final/config.json", "final/pytorch_model.bin", "metrics.jsonl", "predictions_test.csv",
                 "predictions_test_hyp.trn", "predictions_test_ref.trn", "metrics_test.json",
                 "checkpoints/checkpoint_4.pt"):
        assert os.path.exists(os.path.join(trained, name)), name
    logged = [json.loads(line) for line in open(os.path.join(trained, "metrics.jsonl"))]
    assert [r["step"] for r in logged if "loss" in r] == [2, 4]
    assert any("eval/wer" in r for r in logged)


def test_port_trained_model_loads_into_jax_with_equal_logits(trained, corpus, tmp_path):
    final = os.path.join(trained, "final")
    pcfg = load_config(final)
    with open(os.path.join(final, "config.json")) as f:
        jcfg = JConfig.from_dict(json.load(f))
    tree = flax_tree_from_state_dict(load_state(final), pcfg)
    audio = corpus[2][:5]
    wav = np.zeros((5, max(len(a) for a in audio)), np.float32)
    for i, a in enumerate(audio):
        wav[i, :len(a)] = a
    feats, lens = LogMelFrontEnd(LogMelConfig())(jnp.asarray(wav), jnp.asarray([len(a) for a in audio]))
    j_out = JModel(jcfg, dtype=jnp.float32).apply({"params": tree}, feats, lens, deterministic=True)
    model = load_ctc_model(final, device="cpu")
    with torch.no_grad():
        p_out = model(torch.from_numpy(np.array(feats)), torch.from_numpy(np.array(lens)))
    j_logits, p_logits = np.asarray(j_out.logits), p_out.logits.numpy()
    np.testing.assert_array_equal(p_out.logit_lengths.numpy(), np.asarray(j_out.logit_lengths))
    err = np.abs(p_logits - j_logits).max() / np.abs(j_logits).max()
    print(f"\nport-trained model in JAX: largest logit difference {err:.2e} of scale")
    assert err <= 1e-4

    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline

    texts = ASRPipeline(final, tokenizer_dir=corpus[1], model_type="ctc", dtype="float32", device="cpu")(audio)
    assert len(texts) == 5 and all(isinstance(t, str) for t in texts)


def _same_bytes(a, b, name):
    with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
        return fa.read() == fb.read()


def test_evaluate_ctc_writes_the_jax_artifacts(trained, corpus, tmp_path):
    from huggingface_asr_tpu.cli.evaluate import main as j_eval
    from huggingface_asr_tpu.training.model_factory import save_params

    path, tok, _ = corpus
    final = os.path.join(trained, "final")
    with open(os.path.join(final, "config.json")) as f:
        jcfg = JConfig.from_dict(json.load(f))
    jax_dir = str(tmp_path / "jax_final")
    save_params(flax_tree_from_state_dict(load_state(final), load_config(final)), jax_dir, jcfg)
    common = ["--dataset_name", path, "--load_from_disk", "--no-do_resample", "--tokenizer_name", tok,
              "--model_type", "ctc", "--dtype", "float32", "--batch_size", "3"]
    j_out, p_out = str(tmp_path / "jax_eval"), str(tmp_path / "port_eval")
    j_res = j_eval(common + ["--from_pretrained", jax_dir, "--output_dir", j_out])
    p_res = p_evaluate.main(common + ["--from_pretrained", final, "--output_dir", p_out, "--device", "cpu"])
    assert sorted(p_res) == sorted(j_res) == ["test", "validation"]
    for split in p_res:
        assert p_res[split].metrics == j_res[split].metrics
        for suffix in (".csv", "_hyp.trn", "_ref.trn"):
            assert _same_bytes(j_out, p_out, f"predictions_{split}{suffix}")
    assert sorted(os.listdir(p_out)) == sorted(os.listdir(j_out))


def test_evaluate_aed_writes_the_jax_nbest_files(corpus, tmp_path):
    from huggingface_asr_tpu.cli.evaluate import main as j_eval
    from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
    from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig as JJoint
    from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder as JJointModel
    from huggingface_asr_tpu.training.model_factory import save_params
    from transformers import AutoTokenizer

    sys.path.insert(0, REPO)
    from export_jax_checkpoint import export

    path, tok, _ = corpus
    t = AutoTokenizer.from_pretrained(tok)
    V = len(t)
    enc = {**MODEL_CFG, "hidden_size": 48, "intermediate_size": 96, "vocab_size": V}
    dec = dict(vocab_size=V, n_positions=64, n_embd=32, n_layer=1, n_head=2, resid_pdrop=0.0, embd_pdrop=0.0,
               attn_pdrop=0.0, bos_token_id=t.bos_token_id, eos_token_id=t.eos_token_id,
               pad_token_id=t.pad_token_id)
    jcfg = JJoint(encoder=JConfig.from_dict(enc), decoder=JDec(**dec), pad_token_id=t.pad_token_id)
    feats, lens = jnp.zeros((1, 80, 80)), jnp.asarray([80])
    shapes = jax.eval_shape(lambda: JJointModel(jcfg).init(
        jax.random.key(0), feats, lens, labels=jnp.ones((1, 4), jnp.int32), label_lengths=jnp.asarray([4])))
    tree = randomize(shapes["params"], np.random.default_rng(5))
    jax_dir, port_dir = str(tmp_path / "jax_joint"), str(tmp_path / "port_joint")
    save_params(tree, jax_dir, jcfg)
    assert export(jax_dir, port_dir) == "joint"

    common = ["--dataset_name", path, "--load_from_disk", "--no-do_resample", "--tokenizer_name", tok,
              "--model_type", "aed", "--dtype", "float32", "--batch_size", "4", "--num_beams", "3",
              "--ctc_weight", "0.3", "--max_length", "10", "--num_candidates", "8", "--save_nbest",
              "--override_for_evaluation", "length_penalty=0.8"]
    j_out, p_out = str(tmp_path / "jax_eval"), str(tmp_path / "port_eval")
    j_eval(common + ["--from_pretrained", jax_dir, "--output_dir", j_out])
    p_evaluate.main(common + ["--from_pretrained", port_dir, "--output_dir", p_out, "--device", "cpu"])
    files = sorted(os.listdir(j_out))
    assert sorted(os.listdir(p_out)) == files
    assert {"nbest_hyps.txt", "nbest_scores.txt", "nbest_att_scores.txt", "nbest_ctc_scores.txt",
            "nbest_lm_scores.txt"} <= set(files)
    for name in ("nbest_hyps.txt", "predictions_test.csv", "predictions_test_hyp.trn"):
        assert _same_bytes(j_out, p_out, name), name
    for name in ("nbest_scores.txt", "nbest_att_scores.txt", "nbest_ctc_scores.txt", "nbest_lm_scores.txt"):
        rows = [[line.split() for line in open(os.path.join(d, name))] for d in (j_out, p_out)]
        assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]
        np.testing.assert_allclose([float(r[1]) for r in rows[1]], [float(r[1]) for r in rows[0]], atol=1e-4, rtol=1e-6)
