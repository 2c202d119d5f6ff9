"""Model directories, trainer checkpoints, checkpoint averaging and config
overrides (counterpart of ``huggingface_asr_tpu/training/model_factory.py``;
``torch.save`` takes the place of orbax).

A model directory holds ``config.json`` (the JAX package's config fields) and
``pytorch_model.bin`` (a flat state dict with the reference HF keys, the file
``huggingface_asr_tpu/interop/export_hf.py::save_torch_checkpoint`` writes).
Orbax checkpoints cannot be read without JAX; the JAX side converts them.

The recipe families' directories (Whisper-encoder CTC, Whisper seq2seq,
LLM-ASR) hold the same two files; ``load_config`` reads their configs (the
LLM-ASR one nests ``encoder`` and ``decoder``) and ``load_whisper_ctc_model``,
``load_whisper_model`` and ``load_llm_asr_model`` load them for decoding.

A trainer checkpoint is one file ``checkpoint_<step>.pt`` in the trainer's
checkpoint directory: model and optimizer state, step, guard counters, seed.
``average_checkpoints`` averages those files' model states, as the JAX
package averages its orbax checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC
from huggingface_asr_tpu_torch.models.joint_ctc_aed import (
    JointCTCAttentionConfig,
    JointCTCAttentionEncoderDecoder,
)
from huggingface_asr_tpu_torch.utils.argparsing import split_prefixed_overrides
from huggingface_asr_tpu_torch.utils.device import resolve_device

STATE_FILE = "pytorch_model.bin"
_CKPT = re.compile(r"^checkpoint_(\d+)\.pt$")


def load_config(path: str, cls=EBranchformerConfig):
    """The ``config.json`` of a model directory as ``cls`` (any config class
    with ``from_dict``): the CTC model's flat fields, or (``JointCTCAttentionConfig``,
    ``LLMASRConfig``) nested ``encoder`` and ``decoder`` dicts."""
    with open(os.path.join(path, "config.json")) as f:
        return cls.from_dict(json.load(f))


def load_state(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def save_params(model: torch.nn.Module, path: str) -> None:
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


def cast_matrices_(model: torch.nn.Module, dtype: torch.dtype, keep: Tuple[str, ...] = ()) -> torch.nn.Module:
    """Hold the weights and biases of every Linear, Conv1d and Embedding (and
    GPT-2 ``Conv1D``) in ``dtype``, but the modules named in ``keep``: the
    recipe models cast those parameters to their compute dtype at each use,
    so holding them there computes the same function and casts nothing a
    step. LayerNorm parameters and the fp32-applied kernels stay as they are."""
    from huggingface_asr_tpu_torch.models.gpt2_decoder import Conv1D

    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Embedding, Conv1D)) and name not in keep:
            m.to(dtype)
    return model


def _load_recipe_model(path: str, model: torch.nn.Module, device, dtype: Optional[torch.dtype],
                       keep: Tuple[str, ...] = ()) -> torch.nn.Module:
    model.load_state_dict(load_state(path), strict=True)
    if dtype is not None and dtype != torch.float32:
        cast_matrices_(model, dtype, keep)
    return model.to(device).eval()


def load_whisper_ctc_model(path: str, device="cuda", dtype: Optional[torch.dtype] = None):
    """The Whisper-encoder CTC model of a model directory; it computes in the
    dtype of the features it is given, and with ``dtype`` its matrices are
    held in that dtype."""
    from huggingface_asr_tpu_torch.models.whisper_ctc import WhisperCTCConfig, WhisperEncoderForCTC

    device = resolve_device(device)
    return _load_recipe_model(path, WhisperEncoderForCTC(load_config(path, WhisperCTCConfig)), device, dtype)


def load_whisper_model(path: str, device="cuda", dtype: torch.dtype = torch.float32):
    """The Whisper seq2seq model of a model directory, computing in ``dtype``
    (the token embedding stays fp32: the tied head applies it in fp32)."""
    from huggingface_asr_tpu_torch.models.whisper_seq2seq import (
        WhisperForConditionalGeneration,
        WhisperSeq2SeqConfig,
    )

    device = resolve_device(device)
    model = WhisperForConditionalGeneration(load_config(path, WhisperSeq2SeqConfig), dtype)
    return _load_recipe_model(path, model, device, dtype, keep=("model.decoder.embed_tokens",))


def load_llm_asr_model(path: str, device="cuda", dtype: torch.dtype = torch.float32):
    """The LLM-ASR model of a model directory, computing in ``dtype``."""
    from huggingface_asr_tpu_torch.models.llm_asr import LLMASRConfig, LLMASRModel

    device = resolve_device(device)
    return _load_recipe_model(path, LLMASRModel(load_config(path, LLMASRConfig), dtype), device, dtype)


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


def average_checkpoints(checkpoint_dir: str, last_n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Mean of the model states of the trainer checkpoints in
    ``checkpoint_dir`` (the newest ``last_n``, or all), summed in float64 and
    returned as float32, as the JAX package averages its orbax checkpoints
    (reference model_utils.py:54-65 averages all ``checkpoint*/pytorch_model.bin``)."""
    steps = checkpoint_steps(checkpoint_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {checkpoint_dir}")
    if last_n:
        steps = steps[-last_n:]
    acc: Optional[Dict[str, torch.Tensor]] = None
    for step in steps:
        model = load_trainer_checkpoint(checkpoint_dir, step)["model"]
        model = {k: v.to(torch.float64) for k, v in model.items()}
        acc = model if acc is None else {k: acc[k] + v for k, v in model.items()}
    return {k: (v / len(steps)).to(torch.float32) for k, v in acc.items()}


def apply_config_overrides(config, overrides: Dict[str, Any]):
    """Route encoder_/decoder_ prefixed overrides into sub-configs
    (reference fetch_config, model_utils.py:68-114)."""
    enc, dec, rest = split_prefixed_overrides(overrides)
    if isinstance(config, JointCTCAttentionConfig):
        new_enc = dataclasses.replace(config.encoder, **enc) if enc else config.encoder
        new_dec = dataclasses.replace(config.decoder, **dec) if dec else config.decoder
        return dataclasses.replace(config, encoder=new_enc, decoder=new_dec, **rest)
    return dataclasses.replace(config, **{**enc, **rest})


def instantiate_ctc_model(
    config: Optional[EBranchformerConfig] = None,
    from_pretrained: Optional[str] = None,
    from_hf_checkpoint: Optional[str] = None,
    average_checkpoints_dir: Optional[str] = None,
) -> Tuple[EBranchformerForCTC, Optional[Dict[str, torch.Tensor]]]:
    """Build (model, state dict or None) (reference instantiate_ctc_model,
    model_utils.py:117-155). The state dict comes from a model directory, an
    HF checkpoint directory (its ``pytorch_model.bin``: the port's keys are
    HF's, so it loads with ``load_state_dict(strict=True)`` as it is) or the
    mean of a trainer's checkpoints; the caller loads it."""
    state = None
    if from_pretrained:
        config = config or load_config(from_pretrained, EBranchformerConfig)
        state = load_state(from_pretrained)
    elif from_hf_checkpoint:
        assert config is not None, "config required for HF checkpoint conversion"
        state = load_state(from_hf_checkpoint)
    elif average_checkpoints_dir:
        state = average_checkpoints(average_checkpoints_dir)
    return EBranchformerForCTC(config), state


def graft_pretrained_encoder(model: EBranchformerForCTC, state: Dict[str, torch.Tensor]) -> EBranchformerForCTC:
    """Copy an SSL pretraining checkpoint's encoder (its ``wav2vec2.*``
    entries) into ``model``, whose head and adapters keep their values, as the
    JAX ``cli/train_ctc.py`` grafts the checkpoint's ``wav2vec2`` subtree with
    ``jax.tree.map``; the other pretraining entries (BEST-RQ's
    ``classifiers.*`` and ``rpq.*``, wav2vec2's quantizer and projections) are
    dropped. The two encoders must hold the same entries, as ``jax.tree.map``
    demands: a wav2vec2 checkpoint's ``wav2vec2.masked_spec_embed`` has no
    place in a CTC encoder, and the JAX graft refuses it too (ROADMAP.md
    caveat (h))."""
    own = {k for k in model.state_dict() if k.startswith("wav2vec2.")}
    theirs = {k for k in state if k.startswith("wav2vec2.")}
    if own != theirs:
        raise ValueError(f"the pretrained encoder does not match the CTC encoder: entries only in the checkpoint "
                         f"{sorted(theirs - own)}, only in the model {sorted(own - theirs)} (the JAX package's "
                         f"graft refuses such a checkpoint too)")
    missing, unexpected = model.load_state_dict({k: state[k] for k in theirs}, strict=False)
    assert not unexpected and not any(k.startswith("wav2vec2.") for k in missing)
    return model


def _prefixed(prefix: str, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}{k}": v for k, v in state.items()}


def instantiate_aed_model(
    config: Optional[JointCTCAttentionConfig] = None,
    from_pretrained: Optional[str] = None,
    encoder_state: Optional[Dict[str, torch.Tensor]] = None,
    decoder_state: Optional[Dict[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[JointCTCAttentionEncoderDecoder, Optional[Dict[str, torch.Tensor]]]:
    """Build (model, state dict or None) for training (reference
    from_encoder_decoder_pretrained, ctc_encoder...py:138-235): the joint model
    computing in ``dtype`` over fp32 weights. The state dict is a model
    directory's, or else the separately pretrained halves' (a CTC model's
    state dict, a decoder's), keyed ``encoder.*`` / ``decoder.*``; where it
    holds only halves, ``merge_pretrained_halves`` completes it. The caller
    loads it."""
    state = None
    if from_pretrained:
        config = config or load_config(from_pretrained, JointCTCAttentionConfig)
        state = load_state(from_pretrained)
    model = JointCTCAttentionEncoderDecoder(config, dtype, param_dtype=torch.float32)
    if state is None and (encoder_state is not None or decoder_state is not None):
        state = {**_prefixed("encoder.", encoder_state or {}), **_prefixed("decoder.", decoder_state or {})}
    return model, state


def merge_pretrained_halves(init_state: Dict[str, torch.Tensor],
                            encoder_state: Optional[Dict[str, torch.Tensor]] = None,
                            decoder_state: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Graft pretrained halves into a fresh joint state dict: every
    ``encoder.*`` (``decoder.*``) entry of ``init_state`` gives way to the
    half's state dict, keyed without the prefix."""
    state = dict(init_state)
    for prefix, half in (("encoder.", encoder_state), ("decoder.", decoder_state)):
        if half is not None:
            state = {k: v for k, v in state.items() if not k.startswith(prefix)}
            state.update(_prefixed(prefix, half))
    return state
