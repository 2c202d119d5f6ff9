"""Model directories and trainer checkpoints (subset of
``huggingface_asr_tpu/training/model_factory.py``; ``torch.save`` takes the
place of orbax).

A model directory holds ``config.json`` (the JAX package's config fields) and
``pytorch_model.bin`` (a flat state dict with the reference HF keys, the file
``huggingface_asr_tpu/interop/export_hf.py::save_torch_checkpoint`` writes).
Orbax checkpoints cannot be read without JAX; the JAX side converts them.

A trainer checkpoint is one file ``checkpoint_<step>.pt`` in the trainer's
checkpoint directory: model and optimizer state, step, guard counters, seed.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Union

import torch

from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC
from huggingface_asr_tpu_torch.models.joint_ctc_aed import (
    JointCTCAttentionConfig,
    JointCTCAttentionEncoderDecoder,
)
from huggingface_asr_tpu_torch.utils.device import resolve_device

STATE_FILE = "pytorch_model.bin"
_CKPT = re.compile(r"^checkpoint_(\d+)\.pt$")


def load_config(path: str, cls=EBranchformerConfig) -> Union[EBranchformerConfig, JointCTCAttentionConfig]:
    """The ``config.json`` of a model directory as ``cls``: the CTC model's
    flat fields, or (``JointCTCAttentionConfig``) nested ``encoder`` and
    ``decoder`` dicts."""
    with open(os.path.join(path, "config.json")) as f:
        return cls.from_dict(json.load(f))


def load_state(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def save_params(model: Union[EBranchformerForCTC, JointCTCAttentionEncoderDecoder], path: str) -> None:
    """Write a standalone inference checkpoint (``config.json`` +
    ``pytorch_model.bin``), over any earlier one at ``path``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(model.config.to_json())
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(path, STATE_FILE))


def load_ctc_model(path: str, device="cuda") -> EBranchformerForCTC:
    device = resolve_device(device)
    model = EBranchformerForCTC(load_config(path))
    model.load_state_dict(load_state(path), strict=True)
    return model.to(device).eval()


def load_aed_model(path: str, device="cuda", dtype: torch.dtype = torch.float32) -> JointCTCAttentionEncoderDecoder:
    """The joint CTC/attention model of a model directory, computing in ``dtype``."""
    device = resolve_device(device)
    model = JointCTCAttentionEncoderDecoder(load_config(path, JointCTCAttentionConfig), dtype)
    model.load_state_dict(load_state(path), strict=True)
    return model.to(device).eval()


def checkpoint_steps(directory: str) -> List[int]:
    """Steps of the trainer checkpoints in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(directory)) if m)


def save_trainer_checkpoint(directory: str, step: int, payload: Dict[str, Any], keep: int) -> str:
    """Write ``checkpoint_<step>.pt`` (atomically) and prune to the newest ``keep``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"checkpoint_{step}.pt")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    if keep > 0:
        for old in checkpoint_steps(directory)[:-keep]:
            os.remove(os.path.join(directory, f"checkpoint_{old}.pt"))
    return path


def load_trainer_checkpoint(directory: str, step: Optional[int] = None, map_location="cpu") -> Dict[str, Any]:
    steps = checkpoint_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    return torch.load(os.path.join(directory, f"checkpoint_{step}.pt"), map_location=map_location,
                      weights_only=True)
