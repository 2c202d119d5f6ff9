"""PyTorch port, wav2vec2 contrastive pretraining vs the JAX package, on the CPU.

The port's ``models/wav2vec2_ssl.py``, the learned ``masked_spec_embed`` of the
masking hook (``models/ebranchformer.py``), the wav2vec2 table of
``interop/from_jax.py``, ``training/loop.py::Wav2Vec2SSLTrainer`` and
``cli/pretrain.py --pretraining_objective wav2vec2`` against the JAX package's,
on ``tests/test_ssl.py``'s tiny config (G=2 groups of V=16 codes, 4
negatives), parameters carried across from one Flax init:

- the quantizer in training (JAX's own ``jax.random.gumbel`` draw handed to
  the port) and in evaluation: the codes within 1e-5 relative of their scale,
  the perplexity within 1e-5 relative;
- (``tests/test_torch_wav2vec2_objective.py``) the objective in fp32
  (training with JAX's Gumbel draw, and evaluation):
  loss, contrastive loss, diversity and perplexity within 1e-5 relative,
  ``num_masked`` equal, the parameter gradients within 1e-5 of their norm;
  once with each masked frame's first negative set to the frame itself, so
  that the ``isclose`` mask sets logits to -inf;
- (there too) the same in bf16 against JAX bf16, with the self negatives: loss,
  contrastive loss and perplexity within 2e-3 relative, the gradients within
  5e-2 of their norm (bf16 products and casts in two libraries; measured
  4.5e-4 and 3.0e-2);
- ``gumbel_temperature(step)`` equal to JAX's float32 value at steps 0, 1,
  10^5 and 10^7;
- three steps of ``cli/pretrain.run`` whose masks and negatives are what the
  JAX CLI's ``make_ssl_batch_fn`` draws on the same batches.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.cli.pretrain import make_ssl_batch_fn as j_make_ssl_batch_fn
from huggingface_asr_tpu.data.bucketing import BucketedBatchSampler as JBucketedBatchSampler
from huggingface_asr_tpu.data.bucketing import BucketingConfig as JBucketingConfig
from huggingface_asr_tpu.data.collator import CollatorConfig as JCollatorConfig
from huggingface_asr_tpu.data.collator import SpeechCollator as JSpeechCollator
from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.models.ebranchformer import EBranchformerModel as JEncoder
from huggingface_asr_tpu.models.wav2vec2_ssl import GumbelVectorQuantizer as JQuantizer
from huggingface_asr_tpu.models.wav2vec2_ssl import Wav2Vec2ForPreTraining as JWav2Vec2
from huggingface_asr_tpu.ops.features import LogMelConfig as JLogMelConfig
from huggingface_asr_tpu.ops.masking import compute_mask_indices as j_mask_indices
from huggingface_asr_tpu.ops.masking import sample_negative_indices as j_negatives
from huggingface_asr_tpu.training.loop import TrainerConfig as JTrainerConfig
from huggingface_asr_tpu.training.loop import Wav2Vec2SSLTrainer as JTrainer

from huggingface_asr_tpu_torch.cli import pretrain
from huggingface_asr_tpu_torch.data.datasets import ColumnTable, DataConfig
from huggingface_asr_tpu_torch.data.synthetic_speech import corpus_rows
from huggingface_asr_tpu_torch.interop.from_jax import (
    wav2vec2_flax_tree_from_state_dict,
    wav2vec2_state_dict_from_flax,
)
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerModel
from huggingface_asr_tpu_torch.models.wav2vec2_ssl import GumbelVectorQuantizer, Wav2Vec2ForPreTraining
from huggingface_asr_tpu_torch.training.arguments import (
    GeneralTrainingArguments,
    ModelArguments,
    PretrainingArguments,
)
from huggingface_asr_tpu_torch.training.loop import TrainerConfig, Wav2Vec2SSLTrainer

# tests/test_ssl.py's config
TINY = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, conv_dim=(8, 8),
    conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1), vocab_size=30,
    num_codevectors_per_group=16, num_codevector_groups=2, codevector_dim=16, proj_codevector_dim=16,
    num_negatives=4, hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, csgu_conv_dropout=0.0,
    final_dropout=0.0,
)
B, T_MEL, T_ENC = 2, 100, 25
LENS = np.asarray([100, 80], np.int32)
GV = 2 * 16


def _rel(a, b):
    a, b = float(torch.as_tensor(a).detach()) if isinstance(a, torch.Tensor) else float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def tiny():
    """(jax model, params, port model, feats, mask, negatives, JAX's Gumbel draw)."""
    rng = np.random.default_rng(4)
    feats = np.random.default_rng(0).standard_normal((B, T_MEL, 80)).astype(np.float32)
    mask = j_mask_indices((B, T_ENC), 0.6, 3, min_masks=2, rng=rng)
    negs = j_negatives(mask, TINY["num_negatives"], rng=rng)
    jmodel = JWav2Vec2(JConfig(**TINY))
    init = jax.jit(lambda f, n, m, g: jmodel.init({"params": jax.random.key(0), "gumbel": jax.random.key(1)},
                                                  f, n, m, g, deterministic=False))
    params = jax.tree.map(np.asarray, init(jnp.asarray(feats), jnp.asarray(LENS), jnp.asarray(mask),
                                           jnp.asarray(negs))["params"])
    noise = np.asarray(jax.random.gumbel(jax.random.key(7), (B * T_ENC * 2, 16)))
    pmodel = Wav2Vec2ForPreTraining(EBranchformerConfig(**TINY))
    pmodel.load_state_dict(wav2vec2_state_dict_from_flax(params, pmodel.config), strict=True)
    return jmodel, params, pmodel, feats, mask, negs, noise


# ---- the quantizer


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_quantizer_matches_jax(tiny, train):
    _, params, pmodel, *_ = tiny
    hidden = np.random.default_rng(1).standard_normal((B, T_ENC, TINY["hidden_size"])).astype(np.float32)
    valid = np.arange(T_ENC)[None, :] < np.asarray([[25], [19]])
    jq = JQuantizer(JConfig(**TINY))
    key = jax.random.key(3)
    j_cv, j_ppl = jq.apply({"params": params["quantizer"]}, jnp.asarray(hidden), jnp.asarray(valid), 2.0,
                           train=train, gumbel_rng=key)
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, (B * T_ENC * 2, 16)))) if train else None
    cv, ppl = pmodel.quantizer(torch.from_numpy(hidden), torch.from_numpy(valid), 2.0, train=train,
                               gumbel_noise=noise)
    assert isinstance(pmodel.quantizer, GumbelVectorQuantizer)
    j_cv = np.asarray(j_cv)
    np.testing.assert_allclose(cv.detach().numpy(), j_cv, rtol=0, atol=1e-5 * np.abs(j_cv).max())
    assert _rel(ppl, j_ppl) <= 1e-5
    if not train:  # hard codes: each group's code is one of its codevectors, exactly
        book = params["quantizer"]["codevectors"].reshape(2, 16, 8)
        got = cv.detach().numpy().reshape(-1, 2, 8)
        assert all(any(np.array_equal(got[n, g], book[g, v]) for v in range(16)) for n in range(8) for g in range(2))


def test_masked_spec_embed_in_the_hook(tiny):
    """The encoder puts its learned embedding (cast to the compute dtype) in
    the masked frames, as the Flax encoder called without noise does; an
    encoder built without one refuses a mask without noise."""
    _, params, pmodel, feats, mask, _, _ = tiny
    enc = pmodel.wav2vec2
    assert enc.masked_spec_embed.dtype == torch.float32 and enc.masked_spec_embed.shape == (TINY["hidden_size"],)
    def j_encode(f, n, m):
        out = JEncoder(JConfig(**TINY)).apply({"params": params["wav2vec2"]}, f, n, mask_time_indices=m)
        return out.last_hidden_state, out.lengths, out.extract_features

    j_last, j_lengths, j_extract = jax.jit(j_encode)(jnp.asarray(feats), jnp.asarray(LENS), jnp.asarray(mask))
    last, lengths, _, extract = enc(torch.from_numpy(feats), torch.from_numpy(LENS),
                                    mask_time_indices=torch.from_numpy(mask))
    for got, ref in ((last, j_last), (extract, j_extract)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(j_lengths))
    with pytest.raises(ValueError, match="masked_spec_embed"):
        EBranchformerModel(EBranchformerConfig(**TINY))(torch.from_numpy(feats), torch.from_numpy(LENS),
                                                        mask_time_indices=torch.from_numpy(mask))


def test_pretraining_tree_round_trips(tiny):
    _, params, pmodel, *_ = tiny
    sd = pmodel.state_dict()
    assert {"wav2vec2.masked_spec_embed", "quantizer.codevectors", "quantizer.weight_proj.weight",
            "project_hid.weight", "project_q.bias"} <= set(sd)
    assert sd["quantizer.codevectors"].shape == (1, GV, 8)
    tree = wav2vec2_flax_tree_from_state_dict(sd, pmodel.config)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    back = wav2vec2_state_dict_from_flax(tree, pmodel.config)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("step", [0, 1, 10 ** 5, 10 ** 7])
def test_gumbel_temperature_matches_jax(step):
    port = Wav2Vec2SSLTrainer.__new__(Wav2Vec2SSLTrainer)
    port.config = TrainerConfig()
    ref = JTrainer.__new__(JTrainer)
    ref.config = JTrainerConfig()
    want = np.asarray(jax.jit(ref.gumbel_temperature)(jnp.asarray(step, jnp.int32)))
    assert np.float32(port.gumbel_temperature(step)) == want


# ---- the command line


def test_pretrain_cli_runs_three_wav2vec2_steps_with_jax_masks_and_negatives(tmp_path, monkeypatch):
    rows = corpus_rows(n_train=8, n_eval=4, seed=5)
    dataset = {k: ColumnTable(v) for k, v in rows.items()}
    cfg_path = tmp_path / "w2v.json"
    cfg_path.write_text(json.dumps({k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}))
    training = GeneralTrainingArguments(output_dir=str(tmp_path / "out"), per_device_train_batch_size=4,
                                        per_device_eval_batch_size=4, max_steps=3, logging_steps=1, eval_steps=3,
                                        save_steps=100, warmup_steps=1, pad_to_multiple=25, learning_rate=1e-3)
    pargs = PretrainingArguments(pretraining_objective="wav2vec2")
    handed = []  # the masks and negatives run() hands to the trainer, step by step
    real_step = Wav2Vec2SSLTrainer.train_step

    def recording_step(self, state, batch):
        handed.append(tuple(np.asarray(torch.as_tensor(batch[k]).cpu())
                            for k in ("mask_time_indices", "sampled_negative_indices")))
        return real_step(self, state, batch)

    monkeypatch.setattr(Wav2Vec2SSLTrainer, "train_step", recording_step)
    out = pretrain.run(ModelArguments(model_config=str(cfg_path), device="cpu", dtype="float32"), training, pargs,
                       DataConfig(), dataset)
    assert isinstance(out["trainer"], Wav2Vec2SSLTrainer) and out["state"].step == 3
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    steps = [m for m in lines if "loss" in m]
    assert [m["step"] for m in steps] == [1, 2, 3] and all(m["step_applied"] == 1 for m in steps)
    for m in steps:
        assert all(np.isfinite(m[k]) for k in ("loss", "contrastive_loss", "diversity_loss", "codevector_perplexity"))
        assert m["gumbel_temperature"] == pytest.approx(2.0 * 0.999995 ** (m["step"] - 1), rel=1e-6)
    assert any("eval/loss" in m and np.isfinite(m["eval/loss"]) for m in lines)
    sd = torch.load(tmp_path / "out" / "final" / "pytorch_model.bin", weights_only=True)
    assert "wav2vec2.masked_spec_embed" in sd and "quantizer.codevectors" in sd

    # the JAX CLI's draws on the same corpus and seed: its example batch first,
    # then the sampler's batches, through JAX's own collator, sampler and batch function
    j_collator = JSpeechCollator(JCollatorConfig(bucketing=JBucketingConfig(batch_size=4, pad_to_multiple=25 * 160)))
    j_sampler = JBucketedBatchSampler(np.asarray(rows["train"]["input_len"], dtype=np.float64),
                                      JBucketingConfig(batch_size=4, seed=42), num_hosts=1, host_id=0)
    j_fn = j_make_ssl_batch_fn(JConfig(**TINY), pargs, JLogMelConfig(), 42)
    j_fn(j_collator([dataset["train"][0]] * 2))
    want = [j_fn(j_collator([dataset["train"][int(i)] for i in idx]))
            for idx in list(j_sampler.epoch_batches(0))[:3]]
    assert len(handed) == 3
    for (mask, negs), ref in zip(handed, want):
        np.testing.assert_array_equal(mask, ref["mask_time_indices"])
        np.testing.assert_array_equal(negs, ref["sampled_negative_indices"])
