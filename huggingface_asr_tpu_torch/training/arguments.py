"""CLI argument dataclass groups (the port's own copy of
``huggingface_asr_tpu/training/arguments.py``).

Mirrors the reference's four-group HfArgumentParser surface (reference:
src/utilities/training_arguments.py:10-281): ModelArguments,
GeneralTrainingArguments, GenerationArguments, DataTrainingArguments (our
DataConfig), plus PretrainingArguments and TokenizerTrainingArguments.
Parsed by utils.argparsing.DataclassArgumentParser in every CLI entry point.

One field is the port's own: ``ModelArguments.device`` (default "cuda"), the
counterpart of the JAX package's ``JAX_PLATFORMS``; ``--device cpu`` is the
only way a caller asks for the CPU. ``check_supported`` refuses
``--profile_steps``, which the JAX CLIs parse and never forward (ROADMAP.md
reference caveat (m)); ``TrainerConfig.profile_steps`` is the capture.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from huggingface_asr_tpu_torch.data.datasets import DataConfig  # re-exported data group


@dataclasses.dataclass(frozen=True)
class ModelArguments:
    model_config: Optional[str] = None  # JSON file with model config
    from_pretrained: Optional[str] = None  # our checkpoint dir
    from_hf_checkpoint: Optional[str] = None  # reference/HF torch checkpoint
    average_checkpoints: bool = False
    config_overrides: Optional[str] = None  # "key=value;encoder_key=value;..."
    tokenizer_name: Optional[str] = None
    feature_extractor_name: Optional[str] = None
    dtype: str = "bfloat16"
    expect_2d_input: bool = True
    ctc_weight: float = 0.3
    lsm_factor: float = 0.1
    shared_lm_head: bool = False
    decoder_pos_emb_fixed: bool = False
    # AED (train_aed): "decred" (E-Branchformer + GPT-2 joint) or "whisper"
    # (Whisper seq2seq fine-tune, reference train_enc_dec_asr.py:82-85).
    # CTC (train_ctc): default E-Branchformer; "whisper_ctc" (Whisper-encoder
    # CTC, reference recipes_v0.0.1/librispeech_whisper_ctc/whisper_ctc.py)
    # or "llm_asr" (soft-prompted LLM, reference local_models.py:10-243).
    model_family: str = "decred"
    # Whisper generation prompt (reference handle_whisper_generation_config,
    # model_utils.py:248-261): sets forced_decoder_ids from the tokenizer.
    whisper_task: Optional[str] = None
    whisper_language: Optional[str] = None
    # the port's own: where the CLI runs ("cuda" or "cpu")
    device: str = "cuda"


@dataclasses.dataclass(frozen=True)
class GeneralTrainingArguments:
    output_dir: str = "output"
    per_device_train_batch_size: int = 64
    per_device_eval_batch_size: int = 64
    learning_rate: float = 2e-3
    warmup_steps: int = 5000
    max_steps: int = 100_000
    num_train_epochs: Optional[int] = None
    lr_scheduler_type: str = "linear"
    weight_decay: float = 1e-6
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 5.0
    gradient_accumulation_steps: int = 1
    logging_steps: int = 50
    eval_steps: int = 1000
    save_steps: int = 1000
    save_total_limit: int = 5
    early_stopping_patience: int = 0
    metric_for_best_model: str = "eval_loss"
    greater_is_better: bool = False
    seed: int = 42
    bf16: bool = True
    fsdp: bool = False
    restart_from: Optional[str] = None
    start_by_eval: bool = False
    preprocess_dataset_only: bool = False
    report_to_wandb: bool = False
    apply_spec_augment: bool = True
    # reference-style preprocessing JSON (configs/default_data_preprocessing*.json)
    preprocessing_config: Optional[str] = None
    pad_to_multiple: int = 100  # mel frames (recipes use ×100)
    profile_steps: int = 0  # refused: the JAX CLIs never forward it (TrainerConfig.profile_steps captures)
    track_ctc_loss: bool = False


@dataclasses.dataclass(frozen=True)
class GenerationArguments:
    num_beams: int = 1
    max_length: int = 128
    ctc_weight: float = 0.0
    ctc_margin: int = 0
    lm_model: Optional[str] = None
    lm_weight: float = 0.0
    length_penalty: float = 1.0
    num_candidates: int = 64
    eval_beam_factor: int = 1
    apply_eos_space_trick: bool = False
    space_token_id: int = -1
    eos_space_trick_weight: float = 1.0
    override_for_evaluation: Optional[str] = None  # "key=value;..." override
    num_predictions_to_return: int = 1
    save_nbest: bool = False
    post_process_predictions: bool = False  # run EnglishNormalizer on refs/hyps


@dataclasses.dataclass(frozen=True)
class PretrainingArguments:
    pretraining_objective: str = "bestrq"  # bestrq | wav2vec2
    mask_time_prob: float = 0.65
    mask_time_length: int = 10
    min_masks: int = 2
    gumbel_temperature_start: float = 2.0
    gumbel_temperature_end: float = 0.5
    gumbel_temperature_decay: float = 0.999995


@dataclasses.dataclass(frozen=True)
class TokenizerTrainingArguments:
    tokenizer_type: str = "unigram"  # unigram | BPE
    vocab_size: int = 5000
    tokenizer_output_dir: str = "tokenizer"
    additional_raw_text_files: Tuple[str, ...] = ()
    apply_regularization: bool = False
    pad_token: str = "([pad])"
    bos_token: str = "([bos])"
    eos_token: str = "([eos])"
    unk_token: str = "([unk])"
    mask_token: str = "([mask])"


def check_supported(family: str, training: Optional[GeneralTrainingArguments] = None) -> None:
    """Raise ``ValueError`` for ``--profile_steps``: the JAX CLIs parse it and
    never forward it to their trainer, so no run of theirs profiles; a caller
    sets ``TrainerConfig.profile_steps`` instead (ROADMAP.md reference
    caveat (m)). ``family`` is ``--model_family`` of train_ctc/train_aed or
    ``--model_type`` of evaluate; every value of those is ported."""
    if training is not None and training.profile_steps > 0:
        raise ValueError("--profile_steps: the JAX CLIs parse this flag and never forward it, so the port's CLIs "
                         "refuse it; set TrainerConfig.profile_steps (with profile_start and profile_dir) on the "
                         "trainer for a torch.profiler capture (ROADMAP.md reference caveat (m))")
