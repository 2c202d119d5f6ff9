"""HF Whisper checkpoints -> this package's Whisper models (counterpart of
``huggingface_asr_tpu/interop/hf_whisper.py``).

The port's Whisper modules carry HF's names (``models/whisper_ctc.py``,
``models/whisper_seq2seq.py``), so an HF state dict loads with
``load_state_dict(strict=True)`` once its prefix is settled, as the JAX
converter settles it: an HF ``WhisperEncoder`` dict (``conv1.weight`` at the
top) or a reference ``WhisperEncoderForCTC`` one (``encoder.conv1.weight``,
with ``dim_matching``, ``additional_layer_1``, ``subsample_conv{1,2}`` and
``lm_head`` where it was trained); a ``WhisperForConditionalGeneration``
dict with or without its ``model.`` prefix, whose tied ``proj_out.weight``
(the token embedding) is dropped. No ``transformers`` import: a checkpoint
directory is read as ``config.json`` and ``pytorch_model.bin``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Tuple

import torch

from huggingface_asr_tpu_torch.models.whisper_seq2seq import WhisperSeq2SeqConfig

HF_STATE_FILE = "pytorch_model.bin"


def encoder_state_dict_from_hf(state_dict: Mapping[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    """An HF ``WhisperEncoder`` (or reference ``WhisperEncoderForCTC``) state
    dict, its keys under ``prefix``, keyed like ``WhisperEncoderForCTC``: the
    encoder's entries under ``encoder.``, the extensions as they are."""
    p = prefix
    top = f"{p}conv1.weight" in state_dict
    enc = p if top else f"{p}encoder."
    out = {}
    for k, v in state_dict.items():
        if not k.startswith(p):
            continue
        if top:
            out[f"encoder.{k[len(p):]}"] = v
        elif k.startswith(enc):
            out[f"encoder.{k[len(enc):]}"] = v
        else:
            out[k[len(p):]] = v
    return out


def seq2seq_state_dict_from_hf(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF ``WhisperForConditionalGeneration`` state dict keyed like the
    port's: the ``model.`` prefix added where the dict has none, the tied
    ``proj_out.weight`` dropped (it must equal the token embedding)."""
    pre = "" if "model.encoder.conv1.weight" in state_dict else "model."
    out = {f"{pre}{k}": v for k, v in state_dict.items() if k != "proj_out.weight"}
    if "proj_out.weight" in state_dict:
        tied = out["model.decoder.embed_tokens.weight"]
        if not torch.equal(state_dict["proj_out.weight"], tied):
            raise ValueError("proj_out.weight differs from model.decoder.embed_tokens.weight: the port's Whisper "
                             "ties its head to the token embedding, as HF Whisper does")
    return out


def load_hf_whisper_checkpoint(directory: str) -> Tuple[WhisperSeq2SeqConfig, Dict[str, torch.Tensor]]:
    """(config, state dict keyed like ``WhisperForConditionalGeneration``) of
    an HF Whisper directory: ``config.json`` through
    ``WhisperSeq2SeqConfig.from_hf_config``, ``pytorch_model.bin`` through
    ``torch.load``. A directory with safetensors weights only raises: the
    port reads ``pytorch_model.bin`` without ``transformers``."""
    with open(os.path.join(directory, "config.json")) as f:
        config = WhisperSeq2SeqConfig.from_hf_config(json.load(f))
    path = os.path.join(directory, HF_STATE_FILE)
    if not os.path.exists(path):
        found = sorted(n for n in os.listdir(directory) if n.endswith((".safetensors", ".bin")))
        raise FileNotFoundError(f"{directory} holds no {HF_STATE_FILE} (found {found or 'no weights'}): the port "
                                f"loads an HF Whisper checkpoint from {HF_STATE_FILE}; save it with "
                                f"save_pretrained(..., safe_serialization=False)")
    state = torch.load(path, map_location="cpu", weights_only=True)
    return config, seq2seq_state_dict_from_hf(state)
