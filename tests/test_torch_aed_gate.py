"""PyTorch port, the trained-checkpoint gate of the joint CTC/attention path.

A tiny DeCRED is trained through the JAX ``cli/train_aed.py`` (the corpus,
tokenizer and flags of ``tests/test_aed_cli_e2e.py``), converted with
``export_joint`` into ``config.json`` + ``pytorch_model.bin`` and loaded by the
port's ``load_aed_model``. The n-best lists of both packages' ``generate_joint``
must be equal at ``lm_weight`` 0 and 0.3 (a seeded LM converted across), on
the same features at fp32. Near-ties go by the triage rule: a hypothesis may
differ only where its score is within fp32 noise (1e-4) of JAX's at that rank,
and the gap is printed.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.decoding.beam_search import BeamSearchConfig as JBeamCfg
from huggingface_asr_tpu.decoding.generate import generate_joint as j_generate
from huggingface_asr_tpu.interop.export_hf import export_joint, save_torch_checkpoint
from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
from huggingface_asr_tpu.models.gpt2_decoder import GPT2MultiHeadDecoder as JDecoder
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig as JJoint
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder as JModel
from huggingface_asr_tpu.ops.features import LogMelConfig, LogMelFrontEnd
from huggingface_asr_tpu.training.model_factory import load_config, load_params
from torch_port_helpers import randomize

from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig
from huggingface_asr_tpu_torch.decoding.generate import generate_joint
from huggingface_asr_tpu_torch.interop.from_jax import decoder_state_dict_from_flax
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig, GPT2MultiHeadDecoder
from huggingface_asr_tpu_torch.training.model_factory import load_aed_model

datasets = pytest.importorskip("datasets")

WORDS = ["alpha", "beta", "gamma", "delta"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(JAX config, params, port model dir, waveforms) of a DeCRED trained 3 steps by the JAX CLI."""
    from huggingface_asr_tpu.cli.train_aed import main as train_aed
    from huggingface_asr_tpu.cli.train_tokenizer import main as train_tokenizer

    root = tmp_path_factory.mktemp("aed_gate")
    rng = np.random.default_rng(1)
    rows = {"audio": [], "text": [], "input_len": []}
    for _ in range(16):
        n = int(rng.integers(4000, 6000))
        rows["audio"].append(rng.standard_normal(n).astype(np.float32) * 0.1)
        rows["text"].append(" ".join(rng.choice(WORDS, size=rng.integers(1, 4))))
        rows["input_len"].append(n / 16000.0)
    ds = datasets.Dataset.from_dict(rows)
    corpus = str(root / "ds")
    datasets.DatasetDict({"train": ds, "validation": ds.select(range(4)), "test": ds.select(range(4))}) \
        .save_to_disk(corpus)
    tok = str(root / "tok")
    train_tokenizer(["--dataset_name", corpus, "--load_from_disk", "--no-do_resample", "--tokenizer_type", "unigram",
                     "--vocab_size", "40", "--tokenizer_output_dir", tok])
    model_cfg = {
        "encoder": {
            "hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 2,
            "intermediate_size": 64, "conv_dim": [8, 8], "conv_kernel": [3, 3],
            "conv_stride": [2, 2], "conv_padding": [1, 1],
            "hidden_dropout": 0.0, "attention_dropout": 0.0,
        },
        "decoder": {
            "n_embd": 32, "n_layer": 1, "n_head": 2, "n_positions": 64,
            "head_locations": [], "head_weights": [1.0],
            "resid_pdrop": 0.0, "embd_pdrop": 0.0, "attn_pdrop": 0.0,
        },
    }
    (root / "joint.json").write_text(json.dumps(model_cfg))
    out = str(root / "aed_out")
    train_aed([
        "--dataset_name", corpus, "--load_from_disk", "--no-do_resample", "--tokenizer_name", tok,
        "--model_config", str(root / "joint.json"), "--dtype", "float32", "--output_dir", out,
        "--per_device_train_batch_size", "8", "--per_device_eval_batch_size", "4", "--max_steps", "3",
        "--logging_steps", "2", "--eval_steps", "2", "--save_steps", "3", "--warmup_steps", "1",
        "--ctc_weight", "0.3", "--num_beams", "2", "--max_length", "10", "--num_candidates", "8",
        "--override_for_evaluation", "ctc_weight=0.3;num_beams=2", "--max_duration_in_seconds", "2",
        "--pad_to_multiple", "25",
    ])
    final = os.path.join(out, "final")
    jcfg = load_config(final, JJoint)
    params = load_params(final)
    port_dir = str(root / "port")
    os.makedirs(port_dir)
    shutil.copy(os.path.join(final, "config.json"), port_dir)
    save_torch_checkpoint(export_joint(params, jcfg.encoder, jcfg.decoder), os.path.join(port_dir, "pytorch_model.bin"))
    return jcfg, params, port_dir, rows["audio"]


def _seeded_lm(vocab_size):
    cfg = dict(vocab_size=vocab_size, n_positions=64, n_embd=32, n_layer=2, n_head=2, add_cross_attention=False,
               resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    tokens = jnp.zeros((1, 3), jnp.int32)
    shapes = jax.eval_shape(lambda: JDecoder(JDec(**cfg)).init(
        jax.random.key(0), tokens, labels=tokens, label_mask=jnp.ones((1, 3), bool)))["params"]
    tree = randomize(shapes, np.random.default_rng(21))
    lm = GPT2MultiHeadDecoder(GPT2DecoderConfig(**cfg))
    lm.load_state_dict(decoder_state_dict_from_flax(tree, lm.config), strict=True)
    return JDec(**cfg), tree, lm.eval()


@pytest.mark.parametrize("lm_weight", [0.0, 0.3])
def test_trained_checkpoint_nbest_equals_jax(trained, lm_weight, capsys):
    jcfg, params, port_dir, audio = trained
    wav = np.zeros((len(audio), max(len(a) for a in audio)), np.float32)
    for i, a in enumerate(audio):
        wav[i, :len(a)] = a
    lens = np.array([len(a) for a in audio], np.int32)
    feats, feat_lens = LogMelFrontEnd(LogMelConfig(num_mel_bins=jcfg.encoder.num_fbanks))(
        jnp.asarray(wav), jnp.asarray(lens))
    dec = jcfg.decoder
    kw = dict(num_beams=4, max_length=12, ctc_weight=0.3, lm_weight=lm_weight, num_candidates=16,
              bos_token_id=dec.bos_token_id, eos_token_id=dec.eos_token_id, pad_token_id=jcfg.pad_token_id)
    lm_jcfg, lm_tree, lm = _seeded_lm(dec.vocab_size)
    j_seqs, j_scores = j_generate(JModel(jcfg), params, feats, feat_lens, JBeamCfg(**kw), lm_config=lm_jcfg,
                                  lm_params=lm_tree, fused_encoder=False)
    model = load_aed_model(port_dir, device="cpu")
    with torch.no_grad():
        p_seqs, p_scores = generate_joint(model, torch.from_numpy(np.array(feats)), torch.from_numpy(np.array(feat_lens)),
                                          BeamSearchConfig(**kw), lm=lm)
    j_seqs, j_scores = np.asarray(j_seqs), np.asarray(j_scores)
    p_seqs, p_scores = p_seqs.numpy(), p_scores.numpy()
    differ = (p_seqs != j_seqs).any(-1)
    gaps = np.abs(p_scores - j_scores)[differ]
    with capsys.disabled():
        print(f"\ntrained DeCRED, lm_weight {lm_weight}: {int(differ.sum())} of {differ.size} n-best entries differ"
              f"{'' if not differ.any() else f', score gaps at those ranks {gaps.tolist()}'}")
    assert np.all(gaps <= 1e-4)
    np.testing.assert_allclose(p_scores, j_scores, atol=1e-4, rtol=1e-6)
