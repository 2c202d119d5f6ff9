"""PyTorch port, the joint model's command-line surface against the JAX package on the CPU.

``cli/train_aed.py``: a tiny DeCRED (every dropout 0, no SpecAugment, fp32)
trained three steps by the JAX CLI from its own init and by the port's CLI
from that init carried across (``--from_pretrained``); the logged losses
agree, ``final/`` loads strictly, the predictions and the n-best lists are
written. ``cli/train_clm.py``: three steps' losses agree from one init (the
dropout rates set to 0 on both sides, which neither CLI exposes) and
``skip_if_exists``. ``cli/evaluate.py --lm_model`` decodes with the
port-trained LM fused. The tests that need no JAX run (the packed batches,
``--from_hf_gpt2``, the Whisper family's refusals) are in
``tests/test_torch_aed_cli_tools.py``, so that the two files run on two
workers.

The corpus and tokenizer are those of ``tests/test_aed_cli_e2e.py``, with
utterances of 1.5-2 s instead of 0.25-0.4 s, so that every label row has a
CTC alignment (the losses of rows without one are reference caveat (a)).
"""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.cli import train_clm as j_train_clm
from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
from huggingface_asr_tpu.models.gpt2_decoder import GPT2MultiHeadDecoder as JDecoder
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig as JJoint
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder as JModel
from huggingface_asr_tpu.training.model_factory import load_config as j_load_config

from huggingface_asr_tpu_torch.cli import evaluate, train_aed, train_clm
from huggingface_asr_tpu_torch.cli.common import load_fusion_lm
from huggingface_asr_tpu_torch.decoding.generate import generate_joint
from huggingface_asr_tpu_torch.interop.from_jax import decoder_state_dict_from_flax, joint_state_dict_from_flax
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig
from huggingface_asr_tpu_torch.models.joint_ctc_aed import JointCTCAttentionConfig
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
from huggingface_asr_tpu_torch.training.arguments import GenerationArguments
from huggingface_asr_tpu_torch.training.model_factory import STATE_FILE, load_aed_model

datasets = pytest.importorskip("datasets")
transformers = pytest.importorskip("transformers")

WORDS = ["alpha", "beta", "gamma", "delta"]
MODEL = {
    "encoder": {
        "hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 2, "intermediate_size": 64,
        "conv_dim": [8, 8], "conv_kernel": [3, 3], "conv_stride": [2, 2], "conv_padding": [1, 1],
        "hidden_dropout": 0.0, "attention_dropout": 0.0, "activation_dropout": 0.0, "csgu_conv_dropout": 0.0,
        "final_dropout": 0.0,
    },
    "decoder": {
        "n_embd": 24, "n_layer": 2, "n_head": 2, "n_positions": 64, "head_locations": [1],
        "head_weights": [0.3, 0.7], "resid_pdrop": 0.0, "embd_pdrop": 0.0, "attn_pdrop": 0.0,
    },
}
TRAIN = ["--dtype", "float32", "--per_device_train_batch_size", "8", "--per_device_eval_batch_size", "4",
         "--max_steps", "3", "--logging_steps", "1", "--eval_steps", "2", "--save_steps", "3", "--warmup_steps", "1",
         "--no-apply_spec_augment", "--ctc_weight", "0.3", "--num_beams", "2", "--max_length", "10",
         "--num_candidates", "8", "--max_duration_in_seconds", "3", "--pad_to_multiple", "25"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(root, dataset dir, tokenizer dir, texts)."""
    from huggingface_asr_tpu.cli.train_tokenizer import main as train_tokenizer

    root = tmp_path_factory.mktemp("aed_cli")
    rng = np.random.default_rng(1)
    rows = {"audio": [], "text": [], "input_len": []}
    for _ in range(16):
        n = int(rng.integers(24000, 32000))  # 1.5-2 s: every label row has a CTC alignment
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
    (root / "joint.json").write_text(json.dumps(MODEL))
    return root, path, tok, rows["text"]


def _logged(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "loss" in r and "eval/loss" not in r]


@pytest.fixture(scope="module")
def aed_runs(corpus):
    """The JAX train_aed run from its init, and the port's from that init carried across."""
    from huggingface_asr_tpu.cli.train_aed import main as j_train_aed

    root, path, tok, _ = corpus
    common = ["--dataset_name", path, "--load_from_disk", "--no-do_resample", "--tokenizer_name", tok,
              "--model_config", str(root / "joint.json"), *TRAIN]
    j_out = str(root / "jax_aed")
    j_train_aed([*common, "--output_dir", j_out])
    # the JAX CLI's init: its config, key(seed 42), labels given so that every head exists
    jcfg = j_load_config(os.path.join(j_out, "final"), JJoint)
    init = JModel(jcfg).init(jax.random.key(42), jnp.zeros((1, 64, 80)), jnp.asarray([64]),
                             labels=jnp.zeros((1, 4), jnp.int32), label_lengths=jnp.asarray([4]))["params"]
    pcfg = JointCTCAttentionConfig.from_dict(json.load(open(os.path.join(j_out, "final", "config.json"))))
    init_dir = str(root / "port_init")
    os.makedirs(init_dir)
    shutil.copy(os.path.join(j_out, "final", "config.json"), init_dir)
    torch.save(joint_state_dict_from_flax(jax.tree.map(np.asarray, init), pcfg.encoder, pcfg.decoder),
               os.path.join(init_dir, STATE_FILE))
    p_out = str(root / "port_aed")
    results = train_aed.main([*common, "--output_dir", p_out, "--from_pretrained", init_dir, "--device", "cpu",
                              "--save_nbest"])
    return j_out, p_out, results


def test_train_aed_logged_losses_match_jax(aed_runs):
    """Each step's loss, enc_loss, dec_loss and gradient norm within rtol 2e-3
    (the trainer comparison's tolerance), and the evaluation loss too."""
    j_out, p_out, _ = aed_runs
    j_steps, p_steps = _logged(j_out), _logged(p_out)
    assert [r["step"] for r in p_steps] == [r["step"] for r in j_steps] == [1, 2, 3]
    for j, p in zip(j_steps, p_steps):
        assert int(p["step_applied"]) == 1
        for k in ("loss", "enc_loss", "dec_loss", "grad_norm"):
            np.testing.assert_allclose(p[k], j[k], rtol=2e-3, err_msg=f"step {p['step']} {k}")
    with open(os.path.join(j_out, "metrics.jsonl")) as f:
        j_eval = [r for r in map(json.loads, f) if "eval/loss" in r]
    with open(os.path.join(p_out, "metrics.jsonl")) as f:
        p_eval = [r for r in map(json.loads, f) if "eval/loss" in r]
    assert len(p_eval) == len(j_eval) == 1
    np.testing.assert_allclose(p_eval[0]["eval/loss"], j_eval[0]["eval/loss"], rtol=2e-3)


def test_train_aed_writes_final_predictions_and_nbest_lists(aed_runs):
    _, p_out, results = aed_runs
    model = load_aed_model(os.path.join(p_out, "final"), device="cpu")  # strict
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert set(results) == {"test"} and results["test"].num_examples == 4
    for name in ("predictions_test.csv", "predictions_test_hyp.trn", "predictions_test_ref.trn",
                 "nbest_hyps.txt", "nbest_scores.txt", "nbest_att_scores.txt", "nbest_ctc_scores.txt"):
        assert os.path.exists(os.path.join(p_out, name)), name
    with open(os.path.join(p_out, "nbest_hyps.txt")) as f:
        assert len(f.readlines()) == 4 * 2  # four utterances, two beams


# ------------------------------------------------------------ train_clm

CLM = ["--block_size", "16", "--n_embd", "32", "--n_layer", "2", "--n_head", "2", "--per_device_train_batch_size",
       "8", "--per_device_eval_batch_size", "8", "--max_steps", "3", "--logging_steps", "1", "--eval_steps", "1000",
       "--save_steps", "1000", "--warmup_steps", "1", "--learning_rate", "1e-3"]


def _no_dropout(cls):
    return functools.partial(cls, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)


@pytest.fixture(scope="module")
def clm_texts(corpus):
    root, _, tok, texts = corpus
    for name, lines in (("train.txt", texts), ("dev.txt", texts[:6])):
        (root / name).write_text("\n".join(lines) + "\n")
    return ["--tokenizer_name", tok, "--train_text_file", str(root / "train.txt"), "--validation_text_file",
            str(root / "dev.txt")]


@pytest.fixture(scope="module")
def clm_runs(corpus, clm_texts):
    """JAX and port train_clm from one init (the JAX CLI's), dropout off on both sides."""
    root = corpus[0]
    mp = pytest.MonkeyPatch()
    mp.setattr(j_train_clm, "GPT2DecoderConfig", _no_dropout(JDec))
    mp.setattr(train_clm, "GPT2DecoderConfig", _no_dropout(GPT2DecoderConfig))
    try:
        j_out = str(root / "jax_clm")
        j_train_clm.main([*clm_texts, *CLM, "--output_dir", j_out])
        jcfg = j_load_config(os.path.join(j_out, "final"), JDec)
        ids = jnp.zeros((1, 16), jnp.int32)
        init = JDecoder(jcfg).init(jax.random.key(42), ids, labels=ids, label_mask=jnp.ones((1, 16), bool))["params"]
        pcfg = GPT2DecoderConfig.from_dict(json.load(open(os.path.join(j_out, "final", "config.json"))))
        sd = decoder_state_dict_from_flax(jax.tree.map(np.asarray, init), pcfg)
        mp.setattr(train_clm, "init_decoder_from_scratch_", lambda model, gen: model.load_state_dict(sd, strict=True))
        p_out = str(root / "port_clm")
        p_eval = train_clm.main([*clm_texts, *CLM, "--output_dir", p_out, "--device", "cpu"])
    finally:
        mp.undo()
    with open(os.path.join(j_out, "clm_eval.json")) as f:
        j_eval = json.load(f)
    return j_out, p_out, j_eval, p_eval


def test_train_clm_losses_and_perplexity_match_jax(clm_runs):
    j_out, p_out, j_eval, p_eval = clm_runs
    j_steps, p_steps = _logged(j_out), _logged(p_out)
    assert [r["step"] for r in p_steps] == [r["step"] for r in j_steps] == [1, 2, 3]
    for j, p in zip(j_steps, p_steps):
        for k in ("loss", "ppl", "grad_norm"):
            np.testing.assert_allclose(p[k], j[k], rtol=2e-3, err_msg=f"step {p['step']} {k}")
    np.testing.assert_allclose(p_eval["loss"], j_eval["loss"], rtol=2e-3)
    np.testing.assert_allclose(p_eval["perplexity"], j_eval["perplexity"], rtol=2e-3)
    with open(os.path.join(p_out, "final", "config.json")) as f:
        assert json.load(f)["add_cross_attention"] is False


def test_train_clm_skips_an_existing_final_and_resumes(clm_runs, clm_texts, corpus):
    """``skip_if_exists`` leaves ``final/`` as it was; without it a second run
    resumes from the newest checkpoint (step 3) and stops at once."""
    _, p_out, _, _ = clm_runs
    final = os.path.join(p_out, "final", STATE_FILE)
    before = os.path.getmtime(final)
    assert train_clm.main([*clm_texts, *CLM, "--output_dir", p_out, "--device", "cpu"]) is None
    assert os.path.getmtime(final) == before
    again = str(corpus[0] / "port_clm_resume")
    shutil.copytree(p_out, again)
    shutil.rmtree(os.path.join(again, "final"))
    train_clm.main([*clm_texts, *CLM, "--output_dir", again, "--device", "cpu", "--no-skip_if_exists"])
    assert len(_logged(again)) == 3  # the copied records only: no step was taken after the resume


# ------------------------------------------------------------ evaluate --lm_model

def test_evaluate_fuses_a_port_trained_lm(aed_runs, clm_runs, corpus):
    """``evaluate --model_type aed --lm_model`` at lm_weight 0.3: the LM's
    score component is non-zero, and the best hypotheses and scores equal
    ``generate_joint`` called with ``load_fusion_lm``'s LM."""
    _, p_aed, _ = aed_runs
    _, p_clm, _, _ = clm_runs
    root, path, tok, _ = corpus
    out = str(root / "eval_lm")
    flags = ["--num_beams", "2", "--max_length", "10", "--num_candidates", "8", "--ctc_weight", "0.3"]
    evaluate.main(["--dataset_name", path, "--load_from_disk", "--no-do_resample", "--tokenizer_name", tok,
                   "--model_type", "aed", "--from_pretrained", os.path.join(p_aed, "final"), "--lm_model",
                   os.path.join(p_clm, "final"), "--lm_weight", "0.3", "--save_nbest", "--batch_size", "4",
                   "--dtype", "float32", "--device", "cpu", "--output_dir", out, *flags])
    with open(os.path.join(out, "nbest_lm_scores.txt")) as f:
        lm_scores = [float(line.split()[1]) for line in f]
    assert len(lm_scores) == 2 * 2 * 4 and all(s < 0.0 for s in lm_scores)  # two splits, two beams, four each
    with open(os.path.join(out, "nbest_scores.txt")) as f:
        cli_scores = [float(line.split()[1]) for line in f]

    gen = GenerationArguments(num_beams=2, max_length=10, num_candidates=8, ctc_weight=0.3, lm_weight=0.3,
                              lm_model=os.path.join(p_clm, "final"))
    lm = load_fusion_lm(gen, "cpu", torch.float32)
    assert lm is not None and not lm.config.add_cross_attention
    assert load_fusion_lm(GenerationArguments(lm_model=gen.lm_model, lm_weight=0.0), "cpu") is None
    model = load_aed_model(os.path.join(p_aed, "final"), "cpu")
    ds = datasets.load_from_disk(path)["validation"]
    wav = np.zeros((4, 32000), np.float32)
    lens = np.zeros(4, np.int32)
    for i in range(4):
        a = np.asarray(ds[i]["audio"], np.float32)
        wav[i, :len(a)], lens[i] = a, len(a)
    feats, flens = LogMelFrontEnd(LogMelConfig(num_mel_bins=80))(torch.from_numpy(wav), torch.from_numpy(lens))
    cfg = evaluate.build_generation_config(gen, {"bos": model.config.decoder.bos_token_id,
                                                 "eos": model.config.decoder.eos_token_id,
                                                 "pad": model.config.pad_token_id})
    with torch.no_grad():
        _, scores = generate_joint(model, feats, flens, cfg, lm=lm)
    np.testing.assert_allclose(np.asarray(cli_scores[:8]).reshape(4, 2), scores.numpy(), rtol=1e-5, atol=1e-5)
