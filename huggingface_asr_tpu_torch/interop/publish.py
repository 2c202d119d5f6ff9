"""Build (and optionally push) a complete HF-hub model repo from a model
directory (counterpart of ``huggingface_asr_tpu/interop/publish.py``).

Covers the reference's final-model publish flow (reference:
src/trainers/train_enc_dec_asr.py:154-162 — trainer.push_to_hub() +
ModelCard with the tracking-run URL appended + tokenizer.push_to_hub +
feature_extractor.push_to_hub) as an offline-first tool: ``build_hub_repo``
assembles the repo layout on disk from the port's ``final/`` (``config.json``
+ ``pytorch_model.bin``) —

    pytorch_model.bin        the port's state dict, restricted to the
                             reference's keys (the model's parameters: the
                             port's state dicts carry the reference's names)
    config.json              reference model config (loadable by the torch classes)
    tokenizer files          copied from the training tokenizer dir
    preprocessor_config.json CustomFeatureExtractor-compatible FE config
                             (reference: src/utilities/feature_extractors.py)
    README.md                model card (YAML metadata + training summary +
                             the tracking-run URL section the reference appends)

— written as the JAX package writes them, and ``push_to_hub`` uploads that
directory with huggingface_hub where the network allows.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

from huggingface_asr_tpu_torch.ops.features import LogMelConfig

TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "special_tokens_map.json",
    "vocab.json", "merges.txt", "added_tokens.json",
)

_CARD_TEMPLATE = """---
language: {language}
library_name: transformers
tags:
- automatic-speech-recognition
- {arch_tag}
- huggingface_asr_tpu
pipeline_tag: automatic-speech-recognition
---

# {repo_name}

{arch_desc}

Trained with the PyTorch/CUDA port of [huggingface_asr_tpu](https://github.com/)
— a reimplementation of BUT Speech@FIT's `huggingface_asr` — whose weights
carry the reference's torch key names, so it loads with the same code as the
original `BUT-FIT/*` checkpoints.

## Usage

```python
model = AutoModel.from_pretrained("{repo_name}", trust_remote_code=True)
```

## Training configuration

```json
{train_config}
```
"""


def _encoder_config_dict(enc_c, ids: Dict[str, int]) -> Dict[str, Any]:
    """Reference Wav2Vec2EBranchformerConfig fields (the subset the models define)."""
    return {
        "model_type": "wav2vec2-ebranchformer",
        "architectures": ["Wav2Vec2EBranchformerForCTC"],
        "hidden_size": enc_c.hidden_size,
        "num_hidden_layers": enc_c.num_hidden_layers,
        "num_attention_heads": enc_c.num_attention_heads,
        "intermediate_size": enc_c.intermediate_size,
        "conv_dim": list(enc_c.conv_dim),
        "conv_kernel": list(enc_c.conv_kernel),
        "conv_stride": list(enc_c.conv_stride),
        "conv_padding": list(enc_c.conv_padding),
        "num_feat_extract_layers": len(enc_c.conv_dim),
        "num_fbanks": 80,
        "num_mel_bins": 80,
        "second_dim_input_size": 80,
        "use_fbanks": True,
        "vocab_size": enc_c.vocab_size,
        "position_embeddings_type": enc_c.position_embeddings_type,
        "csgu_kernel_size": enc_c.csgu_kernel_size,
        "merge_conv_kernel": enc_c.merge_conv_kernel,
        "csgu_use_linear_after_conv": enc_c.csgu_use_linear_after_conv,
        "csgu_activation": enc_c.csgu_activation,
        "hidden_act": enc_c.hidden_act,
        "apply_spec_augment": False,
        "pad_token_id": ids.get("pad", 0),
        "bos_token_id": ids.get("bos", 1),
        "eos_token_id": ids.get("eos", 2),
        "ctc_loss_reduction": "mean",
        "ctc_zero_infinity": True,
    }


def _decoder_config_dict(dec_c, ids: Dict[str, int]) -> Dict[str, Any]:
    return {
        "model_type": "gpt2-multi-head",
        "vocab_size": dec_c.vocab_size,
        "n_positions": dec_c.n_positions,
        "n_embd": dec_c.n_embd,
        "n_layer": dec_c.n_layer,
        "n_head": dec_c.n_head,
        "n_inner": dec_c.n_inner,
        "add_cross_attention": True,
        "head_locations": list(dec_c.head_locations),
        "head_weights": list(dec_c.head_weights),
        "average_logits": dec_c.average_logits,
        "tie_word_embeddings": False,
        "bos_token_id": ids.get("bos", 1),
        "eos_token_id": ids.get("eos", 2),
        "pad_token_id": ids.get("pad", 0),
    }


def _preprocessor_config(ids: Dict[str, int]) -> Dict[str, Any]:
    """CustomFeatureExtractor kwargs (reference feature_extractors.py:14-37),
    matching ops/features.py LogMelConfig defaults."""
    mel = LogMelConfig()
    return {
        "feature_extractor_type": "CustomFeatureExtractor",
        "feature_size": mel.num_mel_bins,
        "num_mel_bins": mel.num_mel_bins,
        "sampling_rate": mel.sampling_rate,
        "norm_type": mel.norm_type,
        "do_ceptral_normalize": mel.norm_type == "utterance",
        "normalize_means": mel.normalize_means,
        "normalize_vars": mel.normalize_vars,
        "padding_side": "right",
        "padding_value": 0.0,
        "return_attention_mask": True,
    }


def build_hub_repo(
    ckpt_dir: str,
    out_dir: str,
    *,
    model_type: str = "ctc",            # "ctc" | "joint"
    tokenizer_dir: Optional[str] = None,
    repo_name: Optional[str] = None,
    language: str = "en",
    run_url: Optional[str] = None,
    extra_metrics: Optional[Dict[str, Any]] = None,
) -> str:
    """Assemble a pushable HF repo directory from a model directory
    (``config.json`` + ``pytorch_model.bin``, as ``train_ctc`` / ``train_aed``
    write ``final/``).

    Returns out_dir. ``run_url``, when given, is appended as the same
    "### Wandb run" card section the reference adds (train_enc_dec_asr.py:
    156-159).
    """
    from huggingface_asr_tpu_torch.training.model_factory import load_config, load_state

    os.makedirs(out_dir, exist_ok=True)
    state = load_state(ckpt_dir)

    ids: Dict[str, int] = {}
    if tokenizer_dir is not None:
        try:
            from huggingface_asr_tpu_torch.cli.common import load_tokenizer, tokenizer_ids

            ids = tokenizer_ids(load_tokenizer(tokenizer_dir))
        except Exception:
            ids = {}

    if model_type == "joint":
        from huggingface_asr_tpu_torch.models.joint_ctc_aed import (
            JointCTCAttentionConfig,
            JointCTCAttentionEncoderDecoder,
        )

        config = load_config(ckpt_dir, JointCTCAttentionConfig)
        model = JointCTCAttentionEncoderDecoder(config)
        cfg_json = {
            "model_type": "joint_aed_ctc_speech-encoder-decoder",
            "architectures": ["JointCTCAttentionEncoderDecoder"],
            "encoder": _encoder_config_dict(config.encoder, ids),
            "decoder": _decoder_config_dict(config.decoder, ids),
            "ctc_weight": getattr(config, "ctc_weight", 0.3),
        }
        arch_tag, arch_desc = "decred", (
            "Joint CTC + attention encoder-decoder (DeCRED-style): "
            f"E-Branchformer encoder ({config.encoder.num_hidden_layers}L, "
            f"d={config.encoder.hidden_size}) with a multi-head GPT-2 decoder "
            f"({config.decoder.n_layer}L)."
        )
    else:
        from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
        from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC

        config = load_config(ckpt_dir, EBranchformerConfig)
        model = EBranchformerForCTC(config)
        cfg_json = _encoder_config_dict(config, ids)
        arch_tag, arch_desc = "e-branchformer", (
            f"E-Branchformer CTC encoder ({config.num_hidden_layers}L, "
            f"d={config.hidden_size})."
        )
    keys = [name for name, _ in model.named_parameters()]
    sd = {k: state[k].detach().to(torch.float32).contiguous() for k in keys}

    torch.save(sd, os.path.join(out_dir, "pytorch_model.bin"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg_json, f, indent=2, default=str)
    with open(os.path.join(out_dir, "preprocessor_config.json"), "w") as f:
        json.dump(_preprocessor_config(ids), f, indent=2)

    if tokenizer_dir is not None:
        for name in TOKENIZER_FILES:
            src = os.path.join(tokenizer_dir, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, name))

    name = repo_name or os.path.basename(os.path.normpath(out_dir))
    card = _CARD_TEMPLATE.format(
        language=language, arch_tag=arch_tag, repo_name=name,
        arch_desc=arch_desc,
        train_config=json.dumps(cfg_json, indent=2, default=str),
    )
    if extra_metrics:
        card += "\n## Results\n\n```json\n" + json.dumps(
            extra_metrics, indent=2
        ) + "\n```\n"
    if run_url:
        # same section the reference appends to the auto card
        card += f"\n### Wandb run\n{run_url}\n"
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write(card)
    return out_dir


def push_to_hub(repo_dir: str, repo_id: str, token: Optional[str] = None) -> str:
    """Upload a built repo directory (requires network + credentials)."""
    try:
        from huggingface_hub import HfApi
    except ImportError as e:            # pragma: no cover
        raise RuntimeError("huggingface_hub is not installed") from e
    api = HfApi(token=token)
    api.create_repo(repo_id, exist_ok=True)
    api.upload_folder(folder_path=repo_dir, repo_id=repo_id)
    return f"https://huggingface.co/{repo_id}"
