"""Joint CTC/attention (DeCRED/ED) training entry point (counterpart of
``huggingface_asr_tpu/cli/train_aed.py``; reference: src/trainers/train_enc_dec_asr.py).

Flow: parse arg groups -> get_dataset -> tokenizer -> the joint config (the
nested ``--model_config`` with the tokenizer's vocabulary and special ids on
both halves, ``--lsm_factor`` and ``--decoder_pos_emb_fixed`` on the decoder,
``--ctc_weight``, then ``--config_overrides``) -> the model over fp32 weights
(``--from_pretrained``'s state, else the Flax-matching
``init_joint_from_scratch_``) -> bucketed batches of raw waveforms ->
``JointTrainer`` steps on the device (log-mel + SpecAugment + the joint
forward: the encoder's CTC loss through the training attention kernel where
``attention_impl`` selects it, the teacher-forced decoder's smoothed cross
entropy) -> a periodic evaluation loss -> checkpoints -> ``final/``
(``config.json`` + ``pytorch_model.bin``) -> the final joint-decoding
evaluation of every test split: ``final/`` loaded in the serving layout,
``cli/evaluate.py::AedRoute`` (``generate_joint``, with
``--override_for_evaluation``, ``--eval_beam_factor``, ``--lm_model``'s
fusion and the normalizer), CSV and ``.trn`` per split and, with
``--save_nbest``, the n-best lists (the JAX CLI decodes them and drops them;
here they are written, as ``cli/evaluate.py`` writes them).

``--model_family whisper`` fine-tunes the Whisper seq2seq model
(``models/whisper_seq2seq.py``; the JAX CLI's ``_main_whisper``): the model
from ``--from_pretrained``, ``--from_hf_checkpoint`` (an HF Whisper directory's
``config.json`` and ``pytorch_model.bin``, ``interop/hf_whisper.py``) or
``--model_config`` with the tokenizer's vocabulary and special ids, then
``--config_overrides``; ``Seq2SeqTrainer`` steps; ``final/``; and the final
evaluation through ``generate_whisper`` (attention scores alone, the
``--whisper_task`` / ``--whisper_language`` prompt as forced ids).

``main(argv)`` parses the arguments and loads the dataset and the tokenizer
(through ``datasets`` and ``transformers``), and turns the Whisper prompt
into forced ids with the tokenizer's ``get_decoder_prompt_ids``; ``run`` does
the rest, for a caller that brings its own dataset mapping and tokenizer
(and the forced ids). ``--device cpu`` runs on the CPU; the default is the
card.

    python -m huggingface_asr_tpu_torch.cli.train_aed --dataset_name DIR --load_from_disk \\
        --tokenizer_name TOK --model_config configs/decred_base.json --output_dir out [--device cpu]
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from huggingface_asr_tpu_torch.cli.common import (
    epoch_iterator,
    eval_batches,
    load_fusion_lm,
    load_tokenizer,
    save_final,
    setup_logging,
    split_references,
    tokenizer_ids,
)
from huggingface_asr_tpu_torch.cli.evaluate import AedRoute, evaluation_generation_config
from huggingface_asr_tpu_torch.cli.train_ctc import build_trainer_config
from huggingface_asr_tpu_torch.data.bucketing import BucketedBatchSampler, BucketingConfig
from huggingface_asr_tpu_torch.data.collator import CollatorConfig, SpeechCollator
from huggingface_asr_tpu_torch.data.datasets import DataConfig, get_dataset
from huggingface_asr_tpu_torch.data.prefetch import PrefetchIterator, pinned_device_put
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig, parse_dtype
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig
from huggingface_asr_tpu_torch.models.joint_ctc_aed import (
    JointCTCAttentionConfig,
    JointCTCAttentionEncoderDecoder,
    init_joint_from_scratch_,
)
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
from huggingface_asr_tpu_torch.parallel.distributed import initialize_distributed
from huggingface_asr_tpu_torch.training.arguments import (
    GeneralTrainingArguments,
    GenerationArguments,
    ModelArguments,
    check_supported,
)
from huggingface_asr_tpu_torch.training.loop import JointTrainer
from huggingface_asr_tpu_torch.training.model_factory import (
    apply_config_overrides,
    instantiate_aed_model,
    load_aed_model,
)
from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser
from huggingface_asr_tpu_torch.utils.eval_utils import evaluate_splits
from huggingface_asr_tpu_torch.utils.logging_utils import MetricsLogger

logger = logging.getLogger(__name__)


def build_model_config(model_args: ModelArguments, ids: Dict[str, int]) -> JointCTCAttentionConfig:
    """The JAX CLI's joint config: ``--model_config``'s nested ``encoder`` and
    ``decoder`` dicts (else the defaults) with the tokenizer's vocabulary and
    special ids, then ``--config_overrides``."""
    raw = {}
    if model_args.model_config:
        with open(model_args.model_config) as f:
            raw = json.load(f)
    enc = EBranchformerConfig.from_dict({**raw.get("encoder", {}), "vocab_size": ids["vocab_size"]})
    dec = GPT2DecoderConfig.from_dict({
        **raw.get("decoder", {}),
        "vocab_size": ids["vocab_size"],
        "bos_token_id": ids["bos"],
        "eos_token_id": ids["eos"],
        "pad_token_id": ids["pad"],
        "lsm_factor": model_args.lsm_factor,
        "pos_emb_fixed": model_args.decoder_pos_emb_fixed,
    })
    config = JointCTCAttentionConfig(
        encoder=enc, decoder=dec, ctc_weight=model_args.ctc_weight, shared_lm_head=model_args.shared_lm_head,
        decoder_start_token_id=ids["bos"], pad_token_id=ids["pad"],
    )
    if model_args.config_overrides:
        overrides = dict(p.split("=", 1) for p in model_args.config_overrides.split(";"))
        config = apply_config_overrides(config, overrides)
    return config


def build_model(model_args: ModelArguments, config: JointCTCAttentionConfig,
                seed: int) -> JointCTCAttentionEncoderDecoder:
    """The model to train, computing in ``--dtype`` over fp32 weights:
    ``--from_pretrained``'s state dict, loaded strictly, or else the Flax
    init's distributions drawn from ``seed``."""
    model, state = instantiate_aed_model(config, from_pretrained=model_args.from_pretrained,
                                         dtype=parse_dtype(model_args.dtype))
    if state is None:
        return init_joint_from_scratch_(model, torch.Generator().manual_seed(seed))
    model.load_state_dict(state, strict=True)
    return model


def build_whisper_model(model_args: ModelArguments, ids: Dict[str, int], seed: int):
    """(model over fp32 weights computing in ``--dtype``, config) of the
    Whisper family: ``--from_pretrained``'s directory, else
    ``--from_hf_checkpoint``'s HF directory, else ``--model_config`` with the
    tokenizer's vocabulary and special ids and the Flax init's distributions
    drawn from ``seed``; then ``--config_overrides``."""
    from huggingface_asr_tpu_torch.interop.hf_whisper import load_hf_whisper_checkpoint
    from huggingface_asr_tpu_torch.models.whisper_seq2seq import (
        WhisperForConditionalGeneration,
        WhisperSeq2SeqConfig,
        init_seq2seq_from_scratch_,
    )
    from huggingface_asr_tpu_torch.training.model_factory import load_config, load_state

    state = None
    if model_args.from_pretrained:
        config = load_config(model_args.from_pretrained, WhisperSeq2SeqConfig)
        state = load_state(model_args.from_pretrained)
    elif model_args.from_hf_checkpoint:
        config, state = load_hf_whisper_checkpoint(model_args.from_hf_checkpoint)
    elif model_args.model_config:
        with open(model_args.model_config) as f:
            raw = json.load(f)
        config = WhisperSeq2SeqConfig(**{**raw, "vocab_size": ids["vocab_size"], "decoder_start_token_id": ids["bos"],
                                         "eos_token_id": ids["eos"], "pad_token_id": ids["pad"]})
    else:
        raise ValueError("--model_family whisper needs --from_pretrained, --from_hf_checkpoint or --model_config")
    if model_args.config_overrides:
        overrides = dict(p.split("=", 1) for p in model_args.config_overrides.split(";"))
        config = apply_config_overrides(config, overrides)
    model = WhisperForConditionalGeneration(config, parse_dtype(model_args.dtype))
    if state is None:
        init_seq2seq_from_scratch_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state, strict=True)
    return model, config


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
    forced = None
    if model_args.model_family == "whisper" and model_args.whisper_task and model_args.whisper_language:
        # Whisper generation-config handling (reference model_utils.py:248-261)
        forced = tuple(tuple(p) for p in tokenizer.get_decoder_prompt_ids(
            language=model_args.whisper_language, task=model_args.whisper_task))
    return run(model_args, training, gen_args, data_cfg, dataset, tokenizer, forced_decoder_ids=forced)


def run_whisper(model_args: ModelArguments, training: GeneralTrainingArguments, gen_args: GenerationArguments,
                data_cfg: DataConfig, dataset: Mapping[str, Any], tokenizer,
                forced_decoder_ids: Optional[Sequence[Tuple[int, int]]] = None) -> Dict[str, Any]:
    """``--model_family whisper``: train, write ``final/`` and decode the
    test splits with ``generate_whisper``."""
    from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig
    from huggingface_asr_tpu_torch.decoding.generate import generate_whisper
    from huggingface_asr_tpu_torch.training.loop import Seq2SeqTrainer
    from huggingface_asr_tpu_torch.utils.argparsing import parse_override_string

    device = initialize_distributed(model_args.device)
    model, config = build_whisper_model(model_args, tokenizer_ids(tokenizer), training.seed)
    frontend = LogMelFrontEnd(LogMelConfig(num_mel_bins=config.num_mel_bins))
    trainer = Seq2SeqTrainer(model, build_trainer_config(training), frontend=frontend, device=device,
                             dtype=model_args.dtype)
    collator = SpeechCollator(
        CollatorConfig(bucketing=BucketingConfig(batch_size=training.per_device_train_batch_size,
                                                 pad_to_multiple=training.pad_to_multiple * 160)),
        tokenizer=tokenizer,
    )
    train_ds = dataset[data_cfg.train_split]
    sampler = BucketedBatchSampler(
        np.asarray(train_ds[data_cfg.length_column_name], dtype=np.float64),
        BucketingConfig(batch_size=training.per_device_train_batch_size, seed=training.seed),
    )
    state = trainer.init_state()
    if training.restart_from:
        state = trainer.restore_checkpoint(state, None)
    metrics_logger = MetricsLogger(training.output_dir)

    def eval_fn(state):
        val = dataset.get(data_cfg.validation_split)
        if val is None:
            return {}
        losses = []
        for batch in eval_batches(val, collator, training.per_device_eval_batch_size):
            batch.pop("_num_real", None)
            losses.append(float(trainer.eval_step(state, batch)["loss"]))
        return {"loss": float(np.mean(losses))}

    train_iter = PrefetchIterator(epoch_iterator(train_ds, sampler, collator, max_steps=training.max_steps,
                                                 mesh=trainer.mesh),
                                  depth=2, device_put=pinned_device_put(device))
    state = trainer.fit(state, train_iter, eval_fn=eval_fn, hooks=[metrics_logger.log])
    trainer.save_checkpoint(state)
    save_final(trainer, training.output_dir)

    gen_cfg = BeamSearchConfig(
        num_beams=gen_args.num_beams, max_length=gen_args.max_length, ctc_weight=0.0,
        length_penalty=gen_args.length_penalty, num_candidates=gen_args.num_candidates,
        bos_token_id=config.decoder_start_token_id, eos_token_id=config.eos_token_id,
        pad_token_id=config.pad_token_id)
    if gen_args.override_for_evaluation:
        gen_cfg = parse_override_string(gen_args.override_for_evaluation, gen_cfg)
    trainer.model.eval()

    @torch.inference_mode()
    def decode_batch(batch):
        feats, lens = frontend(torch.from_numpy(batch["input_values"]).to(device),
                               torch.from_numpy(batch["input_values_lengths"]).to(device))
        seqs, _ = generate_whisper(trainer.model, feats, lens, gen_cfg, forced_decoder_ids=forced_decoder_ids)
        return [tokenizer.decode([int(t) for t in row[0]], skip_special_tokens=True)
                for row in seqs.cpu().numpy()], None

    test_splits = {name: ds for name, ds in dataset.items()
                   if name not in (data_cfg.train_split, data_cfg.validation_split)}
    return evaluate_splits(
        decode_batch,
        {n: eval_batches(ds, collator, training.per_device_eval_batch_size) for n, ds in test_splits.items()},
        {n: split_references(ds, data_cfg.text_column_name) for n, ds in test_splits.items()},
        output_dir=training.output_dir if trainer.mesh.is_primary else None,
    )


def run(
    model_args: ModelArguments,
    training: GeneralTrainingArguments,
    gen_args: GenerationArguments,
    data_cfg: DataConfig,
    dataset: Mapping[str, Any],
    tokenizer,
    forced_decoder_ids: Optional[Sequence[Tuple[int, int]]] = None,
) -> Dict[str, Any]:
    """Train, write ``final/`` and decode the test splits (jointly, or with
    ``generate_whisper`` and ``forced_decoder_ids`` for the Whisper family);
    returns ``evaluate_splits``' results (split -> ``SplitResult``)."""
    check_supported(model_args.model_family, training)
    if model_args.model_family == "whisper":
        return run_whisper(model_args, training, gen_args, data_cfg, dataset, tokenizer, forced_decoder_ids)
    device = initialize_distributed(model_args.device)
    ids = tokenizer_ids(tokenizer)

    config = build_model_config(model_args, ids)
    model = build_model(model_args, config, training.seed)
    frontend = LogMelFrontEnd(LogMelConfig(num_mel_bins=config.encoder.num_fbanks))
    trainer = JointTrainer(model, build_trainer_config(training), frontend=frontend, device=device,
                           dtype=model_args.dtype)

    collator = SpeechCollator(
        CollatorConfig(
            bucketing=BucketingConfig(
                batch_size=training.per_device_train_batch_size,
                pad_to_multiple=training.pad_to_multiple * 160,  # frames -> samples
            )
        ),
        tokenizer=tokenizer,
    )
    train_ds = dataset[data_cfg.train_split]
    sampler = BucketedBatchSampler(
        np.asarray(train_ds[data_cfg.length_column_name], dtype=np.float64),
        BucketingConfig(batch_size=training.per_device_train_batch_size, seed=training.seed),
    )

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
            losses.append(float(trainer.eval_step(state, batch)["loss"]))
        return {"loss": float(np.mean(losses))}

    train_iter = PrefetchIterator(
        epoch_iterator(train_ds, sampler, collator, max_steps=training.max_steps, mesh=trainer.mesh),
        depth=2,
        device_put=pinned_device_put(device),
    )
    state = trainer.fit(state, train_iter, eval_fn=eval_fn, hooks=[metrics_logger.log])
    trainer.save_checkpoint(state)
    final_dir = save_final(trainer, training.output_dir)

    # ---- the final joint-decoding evaluation, from final/ in the serving layout
    dtype = parse_dtype(model_args.dtype)
    served = load_aed_model(final_dir, device, dtype)
    eval_bs = max(training.per_device_eval_batch_size // max(gen_args.eval_beam_factor, 1), 1)
    route = AedRoute(served, evaluation_generation_config(gen_args, ids), "auto", device,
                     load_fusion_lm(gen_args, device, dtype), gen_args.save_nbest)

    def decode_batch(batch):
        seqs = route(torch.from_numpy(batch["input_values"]).to(device),
                     torch.from_numpy(batch["input_values_lengths"]).to(device))
        return [tokenizer.decode([int(t) for t in row[0]], skip_special_tokens=True) for row in seqs], None

    test_splits = {
        name: ds for name, ds in dataset.items()
        if name not in (data_cfg.train_split, data_cfg.validation_split)
    }
    normalizer = None
    if gen_args.post_process_predictions:
        from huggingface_asr_tpu_torch.utils.normalizer import EnglishNormalizer

        normalizer = EnglishNormalizer()
    results = evaluate_splits(
        decode_batch,
        {n: eval_batches(ds, collator, eval_bs) for n, ds in test_splits.items()},
        {n: split_references(ds, data_cfg.text_column_name) for n, ds in test_splits.items()},
        output_dir=training.output_dir if trainer.mesh.is_primary else None,
        normalizer=normalizer,
    )
    if trainer.mesh.is_primary:
        route.write_nbests(training.output_dir, lambda toks: tokenizer.decode(toks, skip_special_tokens=True))
    return results


if __name__ == "__main__":
    main()
