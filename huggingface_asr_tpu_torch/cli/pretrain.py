"""SSL pretraining entry point (counterpart of ``huggingface_asr_tpu/cli/pretrain.py``;
reference: src/trainers/pretrain.py).

BEST-RQ pretraining of the E-Branchformer encoder: bucketed batches of raw
waveforms, mask spans sampled on the host for every batch
(``make_ssl_batch_fn``, reference collators.py:109-253), then
``BestRQTrainer`` steps on the device (log-mel, the frozen quantizer's
targets, the encoder with the masked frames replaced by noise, the
classifiers' cross entropy), a periodic evaluation loss, checkpoints and
``final/`` (``config.json`` + ``pytorch_model.bin``, the quantizer's buffers
included). No SpecAugment: the span masks take its place.

``main(argv)`` parses the arguments and loads the dataset (through
``datasets``); ``run`` does the rest, for a caller that brings its own
dataset mapping (split -> a table with ``len``, rows and columns, such as
``data.datasets.ColumnTable``). ``--pretraining_objective wav2vec2`` raises
(ROADMAP.md Queue 1 item 10). ``--device cpu`` runs on the CPU; the default
is the card.

    python -m huggingface_asr_tpu_torch.cli.pretrain --dataset_name DIR --load_from_disk \\
        --model_config configs/ebranchformer_90m_ssl.json --output_dir out [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from huggingface_asr_tpu_torch.cli.common import epoch_iterator, eval_batches, setup_logging
from huggingface_asr_tpu_torch.cli.train_ctc import build_trainer_config
from huggingface_asr_tpu_torch.data.bucketing import BucketedBatchSampler, BucketingConfig
from huggingface_asr_tpu_torch.data.collator import CollatorConfig, SpeechCollator
from huggingface_asr_tpu_torch.data.datasets import DataConfig, get_dataset
from huggingface_asr_tpu_torch.data.prefetch import PrefetchIterator, pinned_device_put
from huggingface_asr_tpu_torch.models.bestrq import BestRQForPreTraining
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import (
    feat_extract_output_frames,
    feat_extract_output_lengths,
    init_from_scratch_,
)
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
from huggingface_asr_tpu_torch.ops.masking import compute_mask_indices
from huggingface_asr_tpu_torch.training.arguments import (
    GeneralTrainingArguments,
    ModelArguments,
    PretrainingArguments,
)
from huggingface_asr_tpu_torch.training.loop import BestRQTrainer
from huggingface_asr_tpu_torch.training.model_factory import save_params
from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser
from huggingface_asr_tpu_torch.utils.device import resolve_device
from huggingface_asr_tpu_torch.utils.logging_utils import MetricsLogger

logger = logging.getLogger(__name__)


def make_ssl_batch_fn(config: EBranchformerConfig, pretrain_args: PretrainingArguments,
                      frontend_cfg: LogMelConfig, seed: int = 0):
    """Add ``mask_time_indices`` (B, T_enc) to collated batches: span masks
    over the encoder frames of each utterance's valid length, from one
    ``np.random.default_rng(seed)`` stream, as the JAX function draws them."""
    if pretrain_args.pretraining_objective != "bestrq":
        raise NotImplementedError(_WAV2VEC2)
    rng = np.random.default_rng(seed)

    def fn(batch):
        wav_lens = np.asarray(batch["input_values_lengths"])
        mel_lens = frontend_cfg.num_frames(wav_lens)
        enc_lens = np.asarray(feat_extract_output_lengths(config, mel_lens))
        S = batch["input_values"].shape[1]
        T_enc = int(feat_extract_output_frames(config, int(frontend_cfg.num_frames(S))))
        batch["mask_time_indices"] = compute_mask_indices(
            (len(wav_lens), T_enc),
            pretrain_args.mask_time_prob,
            pretrain_args.mask_time_length,
            lengths=enc_lens,
            min_masks=pretrain_args.min_masks,
            rng=rng,
        )
        return batch

    return fn


_WAV2VEC2 = ("--pretraining_objective wav2vec2 (Gumbel-quantizer contrastive pretraining) is not ported yet "
             "(ROADMAP.md Queue 1 item 10); bestrq is")


def build_model(model_args: ModelArguments, seed: int) -> BestRQForPreTraining:
    """``--model_config``'s model (else the default config) with the Flax
    init's distributions: the encoder as ``init_from_scratch_`` draws it, the
    classifiers lecun_normal (Flax's Dense default), every bias 0."""
    if model_args.model_config:
        with open(model_args.model_config) as f:
            config = EBranchformerConfig.from_dict(json.load(f))
    else:
        config = EBranchformerConfig()
    model = BestRQForPreTraining(config)
    return init_from_scratch_(model, torch.Generator().manual_seed(seed), lecun_linears=model.classifiers)


def main(argv=None):
    parser = DataclassArgumentParser([ModelArguments, GeneralTrainingArguments, PretrainingArguments, DataConfig])
    model_args, training, pretrain_args, data_cfg = parser.parse_args_into_dataclasses(argv)
    if pretrain_args.pretraining_objective != "bestrq":
        raise NotImplementedError(_WAV2VEC2)
    setup_logging(training.output_dir)
    return run(model_args, training, pretrain_args, data_cfg, get_dataset(data_cfg))


def run(
    model_args: ModelArguments,
    training: GeneralTrainingArguments,
    pretrain_args: PretrainingArguments,
    data_cfg: DataConfig,
    dataset: Mapping[str, Any],
) -> Dict[str, Any]:
    """Pretrain, then write the last checkpoint and ``final/``; returns
    ``{"trainer", "state"}``."""
    if pretrain_args.pretraining_objective != "bestrq":
        raise NotImplementedError(_WAV2VEC2)
    device = resolve_device(model_args.device)
    model = build_model(model_args, training.seed)
    config = model.config

    frontend_cfg = LogMelConfig(num_mel_bins=config.num_fbanks)
    trainer_cfg = dataclasses.replace(build_trainer_config(training), spec_augment=None)
    trainer = BestRQTrainer(model, trainer_cfg, frontend=LogMelFrontEnd(frontend_cfg), device=device,
                            dtype=model_args.dtype)

    collator = SpeechCollator(CollatorConfig(bucketing=BucketingConfig(
        batch_size=training.per_device_train_batch_size,
        pad_to_multiple=training.pad_to_multiple * 160,  # frames -> samples
    )))
    batch_fn = make_ssl_batch_fn(config, pretrain_args, frontend_cfg, training.seed)
    train_ds = dataset[data_cfg.train_split]
    sampler = BucketedBatchSampler(
        np.asarray(train_ds[data_cfg.length_column_name], dtype=np.float64),
        BucketingConfig(batch_size=training.per_device_train_batch_size, seed=training.seed),
    )

    # the JAX CLI's example batch: one draw from the mask stream before
    # training, so that every training batch's masks follow the same sequence
    batch_fn(collator([train_ds[0]] * 2))
    state = trainer.init_state()
    if training.restart_from:
        state = trainer.restore_checkpoint(state, None)
    if training.report_to_wandb:
        logger.warning("--report_to_wandb: the port logs to metrics.jsonl only (no W&B sink)")
    metrics_logger = MetricsLogger(training.output_dir)

    def eval_fn(state):
        val = dataset.get(data_cfg.validation_split)
        if val is None:
            return {}
        losses = []
        for batch in eval_batches(val, collator, training.per_device_eval_batch_size):
            batch.pop("_num_real", None)
            losses.append(float(trainer.eval_step(state, batch_fn(batch))["loss"]))
        return {"loss": float(np.mean(losses))}

    train_iter = PrefetchIterator(
        epoch_iterator(train_ds, sampler, collator, max_steps=training.max_steps, extra_fn=batch_fn),
        depth=2,
        device_put=pinned_device_put(device),
    )
    state = trainer.fit(state, train_iter, eval_fn=eval_fn, hooks=[metrics_logger.log])
    trainer.save_checkpoint(state)
    save_params(trainer.model, os.path.join(training.output_dir, "final"))
    return {"trainer": trainer, "state": state}


if __name__ == "__main__":
    main()
