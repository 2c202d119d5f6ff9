"""Model configuration dataclass (counterpart of ``huggingface_asr_tpu/models/configs.py``).

Every field and default is the JAX package's, so the same ``configs/*.json``
and checkpoint ``config.json`` files load in both packages. Fields that only
steer JAX/TPU evaluation (``attention_impl``, ``relpos_impl``,
``dwconv_impl``, ``remat``) are kept so configs round-trip; this package
evaluates relative positions in the factored form only.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class EBranchformerConfig:
    """E-Branchformer encoder (+ 2-D conv mel front end) configuration."""

    # Core transformer
    hidden_size: int = 256
    num_hidden_layers: int = 12
    num_attention_heads: int = 4
    intermediate_size: int = 1024
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02

    # Dropouts
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    final_dropout: float = 0.1
    layerdrop: float = 0.0

    attention_softmax_fp32: bool = True
    attention_impl: str = "auto"  # auto | xla | pallas: which attention core runs (models/ebranchformer.py)
    relpos_impl: str = "factored"  # this package implements "factored" only
    dwconv_impl: str = "conv"  # conv | slice (JAX evaluation knob)
    remat: bool = False
    # Positional embeddings: "relative" | "rotary" | "none"
    position_embeddings_type: str = "relative"
    max_source_positions: int = 5000
    rotary_embedding_base: int = 10000

    # 2-D conv front end over (T, num_fbanks) mel features
    num_fbanks: int = 80
    conv_dim: Tuple[int, ...] = (256, 256)
    conv_kernel: Tuple[int, ...] = (3, 3)
    conv_stride: Tuple[int, ...] = (2, 2)
    conv_padding: Tuple[int, ...] = (1, 1)
    feat_extract_activation: str = "gelu"
    context_awareness_type: Optional[str] = None  # None | "gated" | "gated_shared"
    shared_scale_factor: int = 4

    # E-Branchformer specifics
    csgu_kernel_size: int = 31
    csgu_activation: str = "identity"
    csgu_conv_dropout: float = 0.1
    csgu_use_linear_after_conv: bool = False
    merge_conv_kernel: int = 31
    use_macaron_ff: bool = True
    is_causal: bool = False

    # CTC head
    vocab_size: int = 500
    ctc_loss_reduction: str = "mean"
    ctc_zero_infinity: bool = True

    # SSL masking (hidden-state masking for wav2vec2-style pretraining)
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    mask_feature_min_masks: int = 0

    # wav2vec2 Gumbel quantizer (contrastive SSL)
    num_codevectors_per_group: int = 320
    num_codevector_groups: int = 2
    contrastive_logits_temperature: float = 0.1
    num_negatives: int = 100
    codevector_dim: int = 256
    proj_codevector_dim: int = 256
    diversity_loss_weight: float = 0.1
    feat_quantizer_dropout: float = 0.0

    # BEST-RQ
    best_rq_codebook_size: int = 8192
    best_rq_codebook_dim: int = 16
    best_rq_num_books: int = 1
    best_rq_in_dim: int = 320

    # BEST-RQ fine-tuning adapters
    finetune_with_additional_layer: bool = False
    finetune_with_layer_mixing: bool = False
    freeze_norm_for_finetunning: bool = False

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EBranchformerConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in fields}
        for key in ("conv_dim", "conv_kernel", "conv_stride", "conv_padding"):
            if key in kwargs and isinstance(kwargs[key], list):
                kwargs[key] = tuple(kwargs[key])
        return cls(**kwargs)


def parse_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[name]
