"""CTC ASR training entry point (counterpart of
``huggingface_asr_tpu/cli/train_ctc.py``; reference: src/trainers/train_ctc_asr.py).

Flow: parse arg groups -> get_dataset -> tokenizer -> model (from
``--model_config`` / ``--from_pretrained`` with the tokenizer's vocabulary and
``--config_overrides``; the Flax-matching ``init_from_scratch_`` when nothing
is loaded; from an SSL pretraining ``final/``, its encoder grafted under the
fresh head, with the BEST-RQ adapters where ``--config_overrides`` sets them)
-> bucketed batches of raw waveforms -> ``CTCTrainer`` steps on the
device (log-mel + SpecAugment + E-Branchformer + fp32 CTC) -> periodic
greedy-WER eval -> checkpoints -> ``final/`` (``config.json`` +
``pytorch_model.bin``) -> final per-test-split evaluation (CSV and ``.trn``).

``main(argv)`` parses the arguments and loads the dataset and the tokenizer
(through ``datasets`` and ``transformers``); ``run`` does the rest, for a
caller that brings its own dataset mapping (split -> a table with ``len``,
rows and columns, such as ``data.datasets.ColumnTable``) and tokenizer.
``--model_family whisper_ctc`` trains the Whisper-encoder CTC model
(``models/whisper_ctc.py``) through ``CTCTrainer`` and ``--model_family
llm_asr`` LLM-ASR (``models/llm_asr.py``) through ``LLMASRTrainer``, each from
``--model_config`` (LLM-ASR's nests ``encoder`` and ``decoder``),
``--from_pretrained`` or the JAX defaults, with the tokenizer's vocabulary
(and, for the LLM, its special ids), drawn from the seed where nothing is
loaded. Both refuse ``--from_hf_checkpoint``, which the JAX CLI ignores for
them (ROADMAP.md reference caveat (i)); LLM-ASR ignores
``--config_overrides`` as the JAX CLI does, with a warning. ``--device cpu``
runs on the CPU; the default is the card.

    python -m huggingface_asr_tpu_torch.cli.train_ctc --dataset_name DIR --load_from_disk \\
        --tokenizer_name TOK --model_config model.json --output_dir out [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from huggingface_asr_tpu_torch.cli.common import (
    epoch_iterator,
    eval_batches,
    load_tokenizer,
    save_final,
    setup_logging,
    split_references,
    tokenizer_ids,
)
from huggingface_asr_tpu_torch.data.bucketing import BucketedBatchSampler, BucketingConfig
from huggingface_asr_tpu_torch.data.collator import CollatorConfig, SpeechCollator
from huggingface_asr_tpu_torch.data.datasets import DataConfig, get_dataset
from huggingface_asr_tpu_torch.data.prefetch import PrefetchIterator, pinned_device_put
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig, parse_dtype
from huggingface_asr_tpu_torch.models.ebranchformer import init_from_scratch_
from huggingface_asr_tpu_torch.ops.ctc import tokens_to_lists
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
from huggingface_asr_tpu_torch.ops.spec_augment import SpecAugmentConfig
from huggingface_asr_tpu_torch.parallel.distributed import initialize_distributed
from huggingface_asr_tpu_torch.parallel.mesh import MeshConfig
from huggingface_asr_tpu_torch.training.arguments import (
    GeneralTrainingArguments,
    GenerationArguments,
    ModelArguments,
    check_supported,
)
from huggingface_asr_tpu_torch.training.loop import CTCTrainer, LLMASRTrainer, TrainerConfig
from huggingface_asr_tpu_torch.training.model_factory import (
    apply_config_overrides,
    graft_pretrained_encoder,
    instantiate_ctc_model,
    load_config,
)
from huggingface_asr_tpu_torch.training.optim import OptimizerConfig
from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser
from huggingface_asr_tpu_torch.utils.eval_utils import evaluate_splits, get_metrics
from huggingface_asr_tpu_torch.utils.logging_utils import MetricsLogger

logger = logging.getLogger(__name__)


def build_trainer_config(training: GeneralTrainingArguments) -> TrainerConfig:
    return TrainerConfig(
        optimizer=OptimizerConfig(
            learning_rate=training.learning_rate,
            lr_scheduler_type=training.lr_scheduler_type,
            warmup_steps=training.warmup_steps,
            total_steps=training.max_steps,
            weight_decay=training.weight_decay,
            adam_beta1=training.adam_beta1,
            adam_beta2=training.adam_beta2,
            adam_epsilon=training.adam_epsilon,
            max_grad_norm=training.max_grad_norm,
            gradient_accumulation_steps=training.gradient_accumulation_steps,
        ),
        mesh=MeshConfig(fsdp=training.fsdp),
        spec_augment=SpecAugmentConfig() if training.apply_spec_augment else None,
        log_every=training.logging_steps,
        eval_every=training.eval_steps,
        save_every=training.save_steps,
        max_steps=training.max_steps,
        seed=training.seed,
        checkpoint_dir=os.path.join(os.path.abspath(training.output_dir), "checkpoints"),
        keep_checkpoints=training.save_total_limit,
        early_stopping_patience=training.early_stopping_patience,
        greater_is_better=training.greater_is_better,
        metric_for_best=training.metric_for_best_model,
    )


def build_model_config(model_args: ModelArguments, vocab_size: int) -> EBranchformerConfig:
    """The model config: ``--model_config``'s file, else the architecture of
    ``--from_pretrained`` (possibly an SSL pretrain one), else the defaults;
    the vocabulary from the tokenizer, then ``--config_overrides``."""
    if model_args.model_config:
        with open(model_args.model_config) as f:
            config = EBranchformerConfig.from_dict(json.load(f))
    elif model_args.from_pretrained:
        config = load_config(model_args.from_pretrained, EBranchformerConfig)
    else:
        config = EBranchformerConfig()
    config = dataclasses.replace(config, vocab_size=vocab_size)
    if model_args.config_overrides:
        overrides = dict(p.split("=", 1) for p in model_args.config_overrides.split(";"))
        config = apply_config_overrides(config, overrides)
    return config


def build_recipe_model(model_args: ModelArguments, ids: Dict[str, int], seed: int):
    """``--model_family whisper_ctc|llm_asr``: (model over fp32 weights, its
    config, mel bins, trainer class), as the JAX CLI builds them: the config
    from ``--model_config``, ``--from_pretrained`` or the defaults; the
    tokenizer's vocabulary on the CTC head (and the LLM with its special
    ids); the weights from ``--from_pretrained``, else the Flax init's
    distributions drawn from ``seed``."""
    from huggingface_asr_tpu_torch.models.llm_asr import LLMASRConfig, LLMASRModel, init_llm_asr_from_scratch_
    from huggingface_asr_tpu_torch.models.whisper_ctc import (
        WhisperCTCConfig,
        WhisperEncoderForCTC,
        init_whisper_from_scratch_,
    )
    from huggingface_asr_tpu_torch.training.model_factory import load_state

    family = model_args.model_family
    if model_args.from_hf_checkpoint:
        raise ValueError(f"--from_hf_checkpoint with --model_family {family}: the JAX CLI ignores the flag for this "
                         f"family and trains from its init, and the port has no such route; pass --from_pretrained "
                         f"with a model directory instead (ROADMAP.md reference caveat (i))")
    cls = WhisperCTCConfig if family == "whisper_ctc" else LLMASRConfig
    if model_args.model_config:
        with open(model_args.model_config) as f:
            config = cls.from_dict(json.load(f))
    elif model_args.from_pretrained:
        config = load_config(model_args.from_pretrained, cls)
    else:
        config = cls()
    generator = torch.Generator().manual_seed(seed)
    if family == "whisper_ctc":
        config = dataclasses.replace(config, vocab_size=ids["vocab_size"])
        if model_args.config_overrides:
            overrides = dict(p.split("=", 1) for p in model_args.config_overrides.split(";"))
            config = apply_config_overrides(config, overrides)
        model, init, trainer_cls, num_mel = (WhisperEncoderForCTC(config), init_whisper_from_scratch_, CTCTrainer,
                                             config.num_mel_bins)
    else:
        if model_args.config_overrides:
            logger.warning("--config_overrides is not applied to an llm_asr config (nor by the JAX CLI)")
        config = dataclasses.replace(
            config,
            encoder=dataclasses.replace(config.encoder, vocab_size=ids["vocab_size"]),
            decoder=dataclasses.replace(config.decoder, vocab_size=ids["vocab_size"], bos_token_id=ids["bos"],
                                        eos_token_id=ids["eos"], pad_token_id=ids["pad"]))
        model, init, trainer_cls, num_mel = (LLMASRModel(config, parse_dtype(model_args.dtype)),
                                             init_llm_asr_from_scratch_, LLMASRTrainer,
                                             config.encoder.num_mel_bins)
    if model_args.from_pretrained:
        model.load_state_dict(load_state(model_args.from_pretrained), strict=True)
    else:
        init(model, generator)
    return model, config, num_mel, trainer_cls


def main(argv=None):
    parser = DataclassArgumentParser(
        [ModelArguments, GeneralTrainingArguments, GenerationArguments, DataConfig]
    )
    model_args, training, gen_args, data_cfg = parser.parse_args_into_dataclasses(argv)
    check_supported(model_args.model_family, training)
    setup_logging(training.output_dir)
    if "WORLD_SIZE" in os.environ:  # under torchrun: join before the dataset's rank-0-first calls
        initialize_distributed(model_args.device)

    dataset = get_dataset(data_cfg)
    if training.preprocess_dataset_only:
        return
    tokenizer = load_tokenizer(model_args.tokenizer_name)
    return run(model_args, training, gen_args, data_cfg, dataset, tokenizer)


def run(
    model_args: ModelArguments,
    training: GeneralTrainingArguments,
    gen_args: GenerationArguments,
    data_cfg: DataConfig,
    dataset: Mapping[str, Any],
    tokenizer,
) -> Dict[str, Any]:
    """Train, write ``final/`` and evaluate the test splits; returns
    ``evaluate_splits``' results (split -> ``SplitResult``)."""
    check_supported(model_args.model_family, training)
    device = initialize_distributed(model_args.device)
    ids = tokenizer_ids(tokenizer)

    trainer_cls = CTCTrainer
    if model_args.model_family in ("whisper_ctc", "llm_asr"):
        model, config, num_mel, trainer_cls = build_recipe_model(model_args, ids, training.seed)
    else:
        config = build_model_config(model_args, ids["vocab_size"])
        model, state_dict = instantiate_ctc_model(
            config,
            from_pretrained=model_args.from_pretrained,
            from_hf_checkpoint=model_args.from_hf_checkpoint,
        )
        if state_dict is None or "lm_head.weight" not in state_dict:
            init_from_scratch_(model, torch.Generator().manual_seed(training.seed))
            if state_dict is not None:  # an SSL pretraining checkpoint: its encoder under the fresh head
                graft_pretrained_encoder(model, state_dict)
        else:
            model.load_state_dict(state_dict, strict=True)
        num_mel = config.num_fbanks

    frontend = LogMelFrontEnd(LogMelConfig(num_mel_bins=num_mel))
    trainer_cfg = build_trainer_config(training)

    speed_perturb = None
    if training.preprocessing_config:
        from huggingface_asr_tpu_torch.data.preprocessing_config import load_preprocessing_config

        plan = load_preprocessing_config(training.preprocessing_config, training.seed)
        speed_perturb = plan.audio_transform
        if plan.spec_augment is not None:
            trainer_cfg = dataclasses.replace(
                trainer_cfg,
                spec_augment=plan.spec_augment,
                spec_augment_start_step=plan.spec_augment_start_step,
            )
    trainer = trainer_cls(model, trainer_cfg, frontend=frontend, device=device, dtype=model_args.dtype)

    collator_cfg = CollatorConfig(
        bucketing=BucketingConfig(
            batch_size=training.per_device_train_batch_size,
            pad_to_multiple=training.pad_to_multiple * 160,  # frames -> samples
        )
    )
    train_collator = SpeechCollator(collator_cfg, tokenizer=tokenizer, audio_transform=speed_perturb)
    collator = SpeechCollator(collator_cfg, tokenizer=tokenizer)  # eval: no augment
    train_ds = dataset[data_cfg.train_split]
    sampler = BucketedBatchSampler(
        np.asarray(train_ds[data_cfg.length_column_name], dtype=np.float64),
        BucketingConfig(batch_size=training.per_device_train_batch_size, seed=training.seed),
    )

    state = trainer.init_state()
    if training.restart_from:
        state = trainer.restore_checkpoint(state, None)
    if hasattr(speed_perturb, "set_step"):
        # delayed-start transforms resume from the restored global step
        speed_perturb.set_step(int(state.step))

    if training.report_to_wandb:
        logger.warning("--report_to_wandb: the port logs to metrics.jsonl only (no W&B sink)")
    metrics_logger = MetricsLogger(training.output_dir)

    def decode(batch):
        out = trainer.eval_step(state, batch)
        toks = tokens_to_lists(out["tokens"].cpu().numpy(), out["token_lengths"].cpu().numpy())
        return [tokenizer.decode(t, skip_special_tokens=True) for t in toks], out

    def eval_fn(state):
        val = dataset.get(data_cfg.validation_split)
        if val is None:
            return {}
        hyps, losses = [], []
        for batch in eval_batches(val, collator, training.per_device_eval_batch_size):
            num_real = int(batch.pop("_num_real"))
            texts, out = decode(batch)
            losses.append(float(out["loss"]))
            hyps.extend(texts[:num_real])
        refs = split_references(val, data_cfg.text_column_name)
        assert len(refs) == len(hyps), (len(refs), len(hyps))
        m = get_metrics(refs, hyps)
        return {"loss": float(np.mean(losses)), **m}

    if training.start_by_eval:
        logger.info("start_by_eval: %s", eval_fn(state))

    train_iter = PrefetchIterator(
        epoch_iterator(train_ds, sampler, train_collator, max_steps=training.max_steps, mesh=trainer.mesh),
        depth=2,
        device_put=pinned_device_put(device),
    )
    state = trainer.fit(state, train_iter, eval_fn=eval_fn, hooks=[metrics_logger.log])
    trainer.save_checkpoint(state)
    save_final(trainer, training.output_dir)

    # Final evaluation on all test splits.
    test_splits = {
        name: ds for name, ds in dataset.items()
        if name not in (data_cfg.train_split, data_cfg.validation_split)
    }
    return evaluate_splits(
        lambda batch: (decode(batch)[0], None),
        {
            name: eval_batches(ds, collator, training.per_device_eval_batch_size)
            for name, ds in test_splits.items()
        },
        {name: split_references(ds, data_cfg.text_column_name) for name, ds in test_splits.items()},
        output_dir=training.output_dir if trainer.mesh.is_primary else None,
    )


if __name__ == "__main__":
    main()
