"""PyTorch port, BEST-RQ pretraining vs the JAX package, on the CPU.

The port's own copies (``ops/masking.py``, ``models/bestrq.py``, the SSL
masking hook of ``models/ebranchformer.py``, the pretraining tree of
``interop/from_jax.py``, ``training/loop.py::BestRQTrainer``,
``cli/pretrain.py``) against the JAX package's on the same seeded inputs:

- masks and negatives: identical from one ``np.random.default_rng`` seed;
- the frozen quantizer's buffers, built without JAX: P bit-equal to
  ``make_bestrq_buffers``'s; CB within a few float32 ulp (XLA's ``erf_inv``
  takes XLA's own ``log1p``), and the targets, an argmax over the codebook,
  equal;
- the objective on ``tests/test_ssl.py``'s tiny config (2 books, codebook 64),
  parameters and buffers carried across and JAX's noise passed in: the fp32
  loss within 1e-5 relative, targets and masked counts equal, the parameter
  gradient within 1e-4 of its norm;
- one trainer step, and three steps of ``cli/pretrain.run``, whose masks are
  what the JAX CLI's ``make_ssl_batch_fn`` draws on the same batches.

The wav2vec2 objective is held in ``tests/test_torch_wav2vec2.py``.
"""

import dataclasses
import json
import os

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
from huggingface_asr_tpu.models.bestrq import BestRQForPreTraining as JBestRQ
from huggingface_asr_tpu.models.bestrq import RandomProjectionQuantizer as JRPQ
from huggingface_asr_tpu.models.bestrq import make_bestrq_buffers as j_make_buffers
from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.ops.features import LogMelConfig as JLogMelConfig
from huggingface_asr_tpu.ops.masking import compute_mask_indices as j_mask_indices
from huggingface_asr_tpu.ops.masking import sample_negative_indices as j_negatives

from huggingface_asr_tpu_torch.cli import pretrain
from huggingface_asr_tpu_torch.data.datasets import ColumnTable, DataConfig
from huggingface_asr_tpu_torch.data.synthetic_speech import corpus_rows
from huggingface_asr_tpu_torch.interop.from_jax import (
    pretraining_flax_tree_from_state_dict,
    pretraining_state_dict_from_flax,
)
from huggingface_asr_tpu_torch.models import bestrq as PB
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerModel
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
from huggingface_asr_tpu_torch.ops.masking import compute_mask_indices, sample_negative_indices
from huggingface_asr_tpu_torch.training.arguments import (
    GeneralTrainingArguments,
    ModelArguments,
    PretrainingArguments,
)
from huggingface_asr_tpu_torch.training.loop import BestRQTrainer, TrainerConfig
from huggingface_asr_tpu_torch.training.optim import OptimizerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_ssl.py's config, without its wav2vec2 fields
TINY = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, conv_dim=(8, 8),
    conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1), vocab_size=30,
    best_rq_codebook_size=64, best_rq_codebook_dim=8, best_rq_num_books=2, best_rq_in_dim=320,
    hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, csgu_conv_dropout=0.0, final_dropout=0.0,
)
B, T_MEL, T_ENC = 2, 100, 25
LENS = np.asarray([100, 80], np.int32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


# ---- masking (ops/masking.py)


@pytest.mark.parametrize("shape,prob,length,min_masks,seed", [((8, 200), 0.5, 10, 2, 0), ((3, 250), 0.65, 10, 2, 42),
                                                             ((4, 13), 0.4, 5, 0, 7)])
def test_masks_and_negatives_match_jax(shape, prob, length, min_masks, seed):
    lens = np.linspace(shape[1], 3, shape[0]).astype(np.int64)
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    mask = compute_mask_indices(shape, prob, length, lengths=lens, min_masks=min_masks, rng=a)
    ref = j_mask_indices(shape, prob, length, lengths=lens, min_masks=min_masks, rng=b)
    np.testing.assert_array_equal(mask, ref)
    np.testing.assert_array_equal(sample_negative_indices(mask, 4, rng=a), j_negatives(ref, 4, rng=b))


# ---- the frozen quantizer (models/bestrq.py)


@pytest.mark.parametrize("seed,shape", [(0, (4,)), (1, (3, 5)), (7, (2, 33))])
def test_random_bits_and_uniform_match_jax(seed, shape):
    np.testing.assert_array_equal(PB.random_bits(seed, shape), np.asarray(jax.random.bits(jax.random.key(seed), shape)))
    np.testing.assert_array_equal(PB.random_uniform(seed, shape, -0.3, 0.7),
                                  np.asarray(jax.random.uniform(jax.random.key(seed), shape, jnp.float32, -0.3, 0.7)))


def test_buffers_match_jax_at_the_90m_shapes():
    """P (1 x 320 x 16) bit-equal; CB (1 x 8,192 x 16) within 8 ulp, on a
    small share of its entries; the targets of 240 frames equal."""
    with open(os.path.join(REPO, "configs", "ebranchformer_90m_ssl.json")) as f:
        d = json.load(f)
    got, ref = PB.make_bestrq_buffers(EBranchformerConfig.from_dict(d)), j_make_buffers(JConfig.from_dict(d))["rpq"]
    P, CB = got["P"].numpy(), got["CB"].numpy()
    assert P.shape == (1, 320, 16) and CB.shape == (1, 8192, 16)
    np.testing.assert_array_equal(P, np.asarray(ref["P"]))
    ulps = _ulps(CB, np.asarray(ref["CB"]))
    assert ulps.max() <= 8 and np.mean(ulps > 0) < 0.5, (ulps.max(), np.mean(ulps > 0))
    stacked = np.random.default_rng(0).standard_normal((2, 120, 320)).astype(np.float32)
    rpq = PB.RandomProjectionQuantizer(EBranchformerConfig.from_dict(d))
    j_targets = JRPQ(JConfig.from_dict(d)).apply({"buffers": {"P": ref["P"], "CB": ref["CB"]}}, jnp.asarray(stacked))
    np.testing.assert_array_equal(rpq(torch.from_numpy(stacked)).numpy(), np.asarray(j_targets))


# ---- the objective


@pytest.fixture(scope="module")
def tiny():
    """(jax model, jax variables, port model, feats, mask, JAX's noise)."""
    feats = np.random.default_rng(0).standard_normal((B, T_MEL, 80)).astype(np.float32)
    mask = j_mask_indices((B, T_ENC), 0.5, 3, rng=np.random.default_rng(2))
    jmodel = JBestRQ(JConfig(**TINY))
    init = jax.jit(lambda f, n, m: jmodel.init({"params": jax.random.key(0), "mask_noise": jax.random.key(1)}, f, n, m))
    variables = jax.tree.map(np.asarray, init(jnp.asarray(feats), jnp.asarray(LENS), jnp.asarray(mask)))
    noise = np.asarray(0.1 * jax.random.normal(jax.random.key(2), (B, T_ENC, TINY["hidden_size"]), jnp.float32))
    pmodel = PB.BestRQForPreTraining(EBranchformerConfig(**TINY))
    pmodel.load_state_dict(pretraining_state_dict_from_flax(variables, pmodel.config), strict=True)
    return jmodel, variables, pmodel, feats, mask, noise


def test_bestrq_objective_matches_jax(tiny):
    jmodel, variables, pmodel, feats, mask, noise = tiny

    def j_loss(params):
        out = jmodel.apply({"params": params, "buffers": variables["buffers"]}, jnp.asarray(feats), jnp.asarray(LENS),
                           jnp.asarray(mask), noise_rng=jax.random.key(2), deterministic=True)
        return out.loss, (out.targets, out.num_masked)

    (j_value, (j_targets, j_masked)), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(variables["params"])
    pmodel.zero_grad()
    out = pmodel(torch.from_numpy(feats), torch.from_numpy(LENS), torch.from_numpy(mask),
                 mask_noise=torch.from_numpy(noise))
    out.loss.backward()
    loss = float(out.loss.detach())
    np.testing.assert_array_equal(out.targets.numpy(), np.asarray(j_targets))
    assert int(out.num_masked) == int(j_masked) > 0
    assert abs(loss - float(j_value)) <= 1e-5 * abs(float(j_value))
    grads = {n: p.grad for n, p in pmodel.named_parameters()}
    got = jax.tree.leaves(pretraining_flax_tree_from_state_dict(grads, pmodel.config)["params"])
    ref = jax.tree.leaves(jax.tree.map(np.asarray, j_grads))
    diff = np.sqrt(sum(float(np.sum((g - r) ** 2)) for g, r in zip(got, ref)))
    norm = np.sqrt(sum(float(np.sum(r ** 2)) for r in ref))
    assert norm > 0 and diff <= 1e-4 * norm, (diff, norm)


def test_pretraining_tree_round_trips(tiny):
    _, variables, pmodel, *_ = tiny
    sd = pmodel.state_dict()
    assert not any(n.startswith("rpq") for n, _ in pmodel.named_parameters())
    assert {"rpq.P", "rpq.CB", "classifiers.1.weight"} <= set(sd)
    tree = pretraining_flax_tree_from_state_dict(sd, pmodel.config)
    assert set(tree) == {"params", "buffers"} and set(tree["params"]) == set(variables["params"])
    back = pretraining_state_dict_from_flax(tree, pmodel.config)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_masking_hook_without_noise_names_what_is_missing():
    """An encoder built without wav2vec2's learned embedding (a CTC or BEST-RQ
    encoder) has nothing to put in the masked frames without noise."""
    model = EBranchformerModel(EBranchformerConfig(**TINY))
    with pytest.raises(ValueError, match="masked_spec_embed"):
        model(torch.zeros(1, 16, 80), torch.tensor([16]), mask_time_indices=torch.ones(1, 4, dtype=torch.bool))


# ---- the trainer and the command line


def _batch(fn, seconds=(1.0, 0.7), seed=0):
    rng = np.random.default_rng(seed)
    n = [int(16000 * s) for s in seconds]
    wav = np.zeros((len(n), max(n)), np.float32)
    for i, k in enumerate(n):
        wav[i, :k] = 0.1 * rng.standard_normal(k)
    return fn({"input_values": wav, "input_values_lengths": np.asarray(n, np.int32)})


def test_trainer_step_applies_and_checkpoints_the_buffers(tmp_path):
    cfg = EBranchformerConfig(**TINY)
    model = PB.BestRQForPreTraining(cfg)
    frontend_cfg = LogMelConfig()
    tcfg = TrainerConfig(optimizer=OptimizerConfig(lr_scheduler_type="constant", warmup_steps=0),
                         spec_augment=None, checkpoint_dir=str(tmp_path))
    trainer = BestRQTrainer(model, tcfg, frontend=LogMelFrontEnd(frontend_cfg), device="cpu", dtype="float32")
    batch = _batch(pretrain.make_ssl_batch_fn(cfg, PretrainingArguments(), frontend_cfg, 3))
    state = trainer.init_state()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = trainer.train_step(state, batch)
    assert int(metrics["step_applied"]) == 1 and np.isfinite(float(metrics["loss"]))
    assert float(metrics["num_masked"]) > 0
    assert float(metrics["percent_masked"]) == pytest.approx(100 * float(metrics["num_masked"]) /
                                                             batch["mask_time_indices"].size)
    after = model.state_dict()
    assert not torch.equal(after["classifiers.0.weight"], before["classifiers.0.weight"])
    assert torch.equal(after["rpq.P"], before["rpq.P"]) and torch.equal(after["rpq.CB"], before["rpq.CB"])
    assert np.isfinite(float(trainer.eval_step(state, batch)["loss"]))
    trainer.save_checkpoint(state)
    fresh = BestRQTrainer(PB.BestRQForPreTraining(cfg), tcfg, frontend=LogMelFrontEnd(frontend_cfg), device="cpu",
                          dtype="float32")
    restored = fresh.restore_checkpoint(fresh.init_state())
    assert restored.step == 1
    assert all(torch.equal(v, after[k]) for k, v in fresh.model.state_dict().items())


def test_pretrain_cli_runs_three_steps_with_jax_masks(tmp_path, monkeypatch):
    rows = corpus_rows(n_train=8, n_eval=4, seed=5)
    dataset = {k: ColumnTable(v) for k, v in rows.items()}
    cfg_path = tmp_path / "ssl.json"
    cfg_path.write_text(json.dumps({k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}))
    training = GeneralTrainingArguments(output_dir=str(tmp_path / "out"), per_device_train_batch_size=4,
                                        per_device_eval_batch_size=4, max_steps=3, logging_steps=1, eval_steps=3,
                                        save_steps=100, warmup_steps=1, pad_to_multiple=25, learning_rate=1e-3)
    model_args = ModelArguments(model_config=str(cfg_path), device="cpu", dtype="float32")
    handed = []  # the masks run() hands to the trainer, step by step
    real_step = BestRQTrainer.train_step

    def recording_step(self, state, batch):
        handed.append(np.asarray(torch.as_tensor(batch["mask_time_indices"]).cpu()))
        return real_step(self, state, batch)

    monkeypatch.setattr(BestRQTrainer, "train_step", recording_step)
    out = pretrain.run(model_args, training, PretrainingArguments(), DataConfig(), dataset)
    assert out["state"].step == 3
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    steps = [m for m in lines if "loss" in m]
    assert [m["step"] for m in steps] == [1, 2, 3] and all(m["step_applied"] == 1 for m in steps)
    assert all(np.isfinite(m["loss"]) and m["num_masked"] > 0 for m in steps)
    assert any("eval/loss" in m and np.isfinite(m["eval/loss"]) for m in lines)
    final = tmp_path / "out" / "final"
    assert (final / "config.json").exists()
    sd = torch.load(final / "pytorch_model.bin", weights_only=True)
    assert torch.equal(sd["rpq.P"], PB.make_bestrq_buffers(EBranchformerConfig(**TINY))["P"])

    # the JAX CLI's sequence of draws on the same corpus and seed: its example
    # batch first, then the sampler's batches, through JAX's own collator,
    # sampler and batch function
    pargs = PretrainingArguments()
    j_collator = JSpeechCollator(JCollatorConfig(bucketing=JBucketingConfig(batch_size=4, pad_to_multiple=25 * 160)))
    j_sampler = JBucketedBatchSampler(np.asarray(rows["train"]["input_len"], dtype=np.float64),
                                      JBucketingConfig(batch_size=4, seed=42), num_hosts=1, host_id=0)
    j_fn = j_make_ssl_batch_fn(JConfig(**TINY), pargs, JLogMelConfig(), 42)
    j_fn(j_collator([dataset["train"][0]] * 2))
    want = [j_fn(j_collator([dataset["train"][int(i)] for i in idx]))["mask_time_indices"]
            for idx in list(j_sampler.epoch_batches(0))[:3]]
    assert len(handed) == 3
    for got, ref in zip(handed, want):
        np.testing.assert_array_equal(got, ref)

