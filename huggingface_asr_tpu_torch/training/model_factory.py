"""Checkpoint directories (subset of ``huggingface_asr_tpu/training/model_factory.py``).

A model directory holds ``config.json`` (the JAX package's config fields) and
``pytorch_model.bin`` (a flat state dict with the reference HF keys — the file
``huggingface_asr_tpu/interop/export_hf.py::save_torch_checkpoint`` writes).
Orbax checkpoints cannot be read without JAX; the JAX side converts them.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC

STATE_FILE = "pytorch_model.bin"


def load_config(path: str) -> EBranchformerConfig:
    return EBranchformerConfig.from_json_file(os.path.join(path, "config.json"))


def load_state(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def save_checkpoint(model: EBranchformerForCTC, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(model.config.to_json())
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(path, STATE_FILE))


def load_ctc_model(path: str, device="cpu") -> EBranchformerForCTC:
    model = EBranchformerForCTC(load_config(path))
    model.load_state_dict(load_state(path), strict=True)
    return model.to(device).eval()
