"""SSL pretraining entry point (counterpart of ``huggingface_asr_tpu/cli/pretrain.py``;
reference: src/trainers/pretrain.py).

BEST-RQ or wav2vec2-contrastive pretraining of the E-Branchformer encoder:
bucketed batches of raw waveforms, mask spans (and, for wav2vec2, negative
indices) sampled on the host for every batch (``make_ssl_batch_fn``,
reference collators.py:109-253), then trainer steps on the device:
``BestRQTrainer`` (log-mel, the frozen quantizer's targets, the encoder with
the masked frames replaced by noise, the classifiers' cross entropy) or
``Wav2Vec2SSLTrainer`` (log-mel, the encoder with the learned mask embedding,
the Gumbel quantizer at the step's temperature, the contrastive and diversity
losses); a periodic evaluation loss, checkpoints and ``final/``
(``config.json`` + ``pytorch_model.bin``, BEST-RQ's quantizer buffers
included). No SpecAugment: the span masks take its place. ``train_ctc
--from_pretrained`` fine-tunes the encoder of a BEST-RQ ``final/``.

``main(argv)`` parses the arguments and loads the dataset (through
``datasets``); ``run`` does the rest, for a caller that brings its own
dataset mapping (split -> a table with ``len``, rows and columns, such as
``data.datasets.ColumnTable``). ``--device cpu`` runs on the CPU; the
default is the card.

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

from huggingface_asr_tpu_torch.cli.common import epoch_iterator, eval_batches, save_final, setup_logging
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
from huggingface_asr_tpu_torch.models.wav2vec2_ssl import Wav2Vec2ForPreTraining
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
from huggingface_asr_tpu_torch.ops.masking import compute_mask_indices, sample_negative_indices
from huggingface_asr_tpu_torch.parallel.distributed import initialize_distributed
from huggingface_asr_tpu_torch.training.arguments import (
    GeneralTrainingArguments,
    ModelArguments,
    PretrainingArguments,
)
from huggingface_asr_tpu_torch.training.loop import BestRQTrainer, Wav2Vec2SSLTrainer
from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser
from huggingface_asr_tpu_torch.utils.logging_utils import MetricsLogger

logger = logging.getLogger(__name__)


def make_ssl_batch_fn(config: EBranchformerConfig, pretrain_args: PretrainingArguments,
                      frontend_cfg: LogMelConfig, seed: int = 0):
    """Add ``mask_time_indices`` (B, T_enc) to collated batches: span masks
    over the encoder frames of each utterance's valid length, and for
    wav2vec2 ``sampled_negative_indices`` (B, T_enc, num_negatives), from one
    ``np.random.default_rng(seed)`` stream, as the JAX function draws them.
    A data-parallel rank's batch (``_rows``) gets its rows of the global
    batch's draws."""
    rng = np.random.default_rng(seed)
    is_w2v2 = pretrain_args.pretraining_objective == "wav2vec2"

    def fn(batch):
        wav_lens = np.asarray(batch.get("_all_lengths", batch["input_values_lengths"]))
        mel_lens = frontend_cfg.num_frames(wav_lens)
        enc_lens = np.asarray(feat_extract_output_lengths(config, mel_lens))
        S = batch["input_values"].shape[1]
        T_enc = int(feat_extract_output_frames(config, int(frontend_cfg.num_frames(S))))
        mask = compute_mask_indices(
            (len(wav_lens), T_enc),
            pretrain_args.mask_time_prob,
            pretrain_args.mask_time_length,
            lengths=enc_lens,
            min_masks=pretrain_args.min_masks,
            rng=rng,
        )
        negatives = sample_negative_indices(mask, config.num_negatives, rng=rng) if is_w2v2 else None
        rows = slice(*batch["_rows"][:2]) if "_rows" in batch else slice(None)
        batch["mask_time_indices"] = mask[rows]
        if is_w2v2:
            batch["sampled_negative_indices"] = negatives[rows]
        return batch

    return fn


def build_model(model_args: ModelArguments, seed: int, objective: str = "bestrq"):
    """``--model_config``'s model (else the default config) for ``objective``
    with the Flax init's distributions: the encoder as ``init_from_scratch_``
    draws it; BEST-RQ's classifiers, or wav2vec2's ``weight_proj``,
    ``project_hid`` and ``project_q``, lecun_normal (Flax's Dense default);
    every bias 0; wav2vec2's ``masked_spec_embed`` and ``codevectors``
    uniform on [0, 1)."""
    if objective not in ("bestrq", "wav2vec2"):
        raise ValueError(f"unknown pretraining_objective {objective!r} (bestrq | wav2vec2)")
    if model_args.model_config:
        with open(model_args.model_config) as f:
            config = EBranchformerConfig.from_dict(json.load(f))
    else:
        config = EBranchformerConfig()
    generator = torch.Generator().manual_seed(seed)
    if objective == "wav2vec2":
        model = Wav2Vec2ForPreTraining(config)
        return init_from_scratch_(model, generator,
                                  lecun_linears=(model.quantizer.weight_proj, model.project_hid, model.project_q))
    model = BestRQForPreTraining(config)
    return init_from_scratch_(model, generator, lecun_linears=model.classifiers)


def main(argv=None):
    parser = DataclassArgumentParser([ModelArguments, GeneralTrainingArguments, PretrainingArguments, DataConfig])
    model_args, training, pretrain_args, data_cfg = parser.parse_args_into_dataclasses(argv)
    setup_logging(training.output_dir)
    if "WORLD_SIZE" in os.environ:  # under torchrun: join before the dataset's rank-0-first calls
        initialize_distributed(model_args.device)
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
    device = initialize_distributed(model_args.device)
    objective = pretrain_args.pretraining_objective
    model = build_model(model_args, training.seed, objective)
    config = model.config

    frontend_cfg = LogMelConfig(num_mel_bins=config.num_fbanks)
    trainer_cfg = dataclasses.replace(
        build_trainer_config(training),
        spec_augment=None,
        gumbel_temperature_start=pretrain_args.gumbel_temperature_start,
        gumbel_temperature_end=pretrain_args.gumbel_temperature_end,
        gumbel_temperature_decay=pretrain_args.gumbel_temperature_decay,
    )
    trainer_cls = Wav2Vec2SSLTrainer if objective == "wav2vec2" else BestRQTrainer
    trainer = trainer_cls(model, trainer_cfg, frontend=LogMelFrontEnd(frontend_cfg), device=device,
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
        epoch_iterator(train_ds, sampler, collator, max_steps=training.max_steps, extra_fn=batch_fn,
                       mesh=trainer.mesh),
        depth=2,
        device_put=pinned_device_put(device),
    )
    state = trainer.fit(state, train_iter, eval_fn=eval_fn, hooks=[metrics_logger.log])
    trainer.save_checkpoint(state)
    save_final(trainer, training.output_dir)
    return {"trainer": trainer, "state": state}


if __name__ == "__main__":
    main()
