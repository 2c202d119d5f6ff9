"""Serving: ASR pipeline + inference-endpoint handler
(counterpart of ``huggingface_asr_tpu/serving/pipeline.py``).

waveform(s) -> log-mel -> either the joint CTC/attention model and its beam
search (``model_type="aed"``, the default) or the E-Branchformer CTC model and
greedy collapse (``"ctc"``) -> text. Inputs are padded up to the next of a few
length buckets, so a server sees a handful of shapes. The pipeline runs on the
card unless the caller passes ``device="cpu"``; without a card the default
raises.

On a CUDA device, where ``fused_encoder_refusal`` takes the encoder config and
dtype, the encoder runs the CUDA kernels (``kernels/``): the CTC route from
the log-mel kernel on, the AED route from the subsampler on, behind the plain
log-mel front end, as the JAX AED route runs the XLA front end. Otherwise the
plain model runs and the reason is logged.

``numeric_profile`` selects the CTC kernel route's numerics, as the JAX
pipeline's fused route sets them (pipeline.py:86-113): ``"serving"`` (the
default) runs the log-mel kernel's single bf16 DFT pass
(``matmul_precision="bf16"``) with the fused CMVN and the ``"serving"``
profile of K2 and K1 (``kernels/layer.py::PROFILES``); ``"exact"`` keeps
the fp32 DFT and the exact profile. The serving route was admitted by the
transcript gate (``tests/test_torch_cli_gate.py``, ``chip_smoke.py``): the
committed gate model's 64 utterances give the JAX serving composition's ids.
The other routes (the plain model, the AED route) stay on the exact
contract, as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from huggingface_asr_tpu_torch.cli.common import tokenizer_ids
from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig
from huggingface_asr_tpu_torch.decoding.generate import generate_joint
from huggingface_asr_tpu_torch.kernels.layer import check_profile
from huggingface_asr_tpu_torch.kernels.mel import MelFrontEnd
from huggingface_asr_tpu_torch.models.configs import parse_dtype
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer, fused_encoder_refusal
from huggingface_asr_tpu_torch.ops.ctc import ctc_greedy_decode, tokens_to_lists
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
from huggingface_asr_tpu_torch.training.model_factory import load_aed_model, load_ctc_model
from huggingface_asr_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class ASRPipeline:
    """``tokenizer`` is an object with ``decode(ids, skip_special_tokens=True)``
    (and, for the AED route, HF's ``bos_token_id``, ``eos_token_id``,
    ``pad_token_id``, ``unk_token_id`` and ``len``); without one, an HF
    tokenizer is loaded from ``tokenizer_dir`` (or the model directory)
    through ``transformers``. ``fused_encoder``: "auto" takes the kernels where
    they apply; False keeps the plain encoder; True requires the kernels.
    ``numeric_profile``: the CTC kernel route's profile, "serving" or "exact"
    (the module docstring)."""

    def __init__(
        self,
        model_dir: str,
        tokenizer_dir: Optional[str] = None,
        model_type: str = "aed",  # aed | ctc
        ctc_weight: float = 0.3,
        num_beams: int = 5,
        max_length: int = 128,
        dtype: str = "bfloat16",
        length_buckets: Sequence[float] = (2.0, 5.0, 10.0, 20.0, 30.0),
        sampling_rate: int = 16000,
        fused_encoder: Union[bool, str] = "auto",
        device: Union[str, torch.device] = "cuda",
        tokenizer=None,
        numeric_profile: str = "serving",
    ):
        if model_type not in ("aed", "ctc"):
            raise ValueError(f"model_type={model_type!r}: 'aed' or 'ctc'")
        check_profile(numeric_profile)
        self.device = resolve_device(device)
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(tokenizer_dir or model_dir)
        self.tokenizer = tokenizer
        self.sampling_rate = sampling_rate
        self.length_buckets = sorted(length_buckets)
        self.model_type = model_type
        dt = parse_dtype(dtype)

        if model_type == "ctc":
            model = load_ctc_model(model_dir, self.device)
            enc_config = model.config
        else:
            model = load_aed_model(model_dir, self.device, dt)
            enc_config = model.config.encoder
        refusal = fused_encoder_refusal(enc_config, dt, log_mel=model_type == "ctc")
        if fused_encoder == "auto":
            self._use_fused = self.device.type == "cuda" and refusal is None
            if self.device.type == "cuda" and refusal is not None:
                logger.warning("serving through the plain model, not the fused kernels: %s", refusal)
        elif fused_encoder and refusal is not None:
            raise ValueError(f"fused_encoder=True but the kernel path does not take this model: {refusal}")
        else:
            self._use_fused = bool(fused_encoder)
        mel_cfg = LogMelConfig(num_mel_bins=enc_config.num_fbanks)
        # the CTC kernel route's numeric profile; the AED route stays exact
        self.numeric_profile = numeric_profile if model_type == "ctc" and self._use_fused else "exact"
        self._fused = FusedCTC(model if model_type == "ctc" else model.encoder, self.device,
                               profile=self.numeric_profile) if self._use_fused else None

        if model_type == "ctc":
            if self._use_fused:
                precision = "bf16" if self.numeric_profile == "serving" else "highest"
                self._frontend = MelFrontEnd(dataclasses.replace(mel_cfg, matmul_precision=precision),
                                             device=self.device)
            else:
                self._model = model.to(dt)
                self._dtype = dt
                self._frontend = LogMelFrontEnd(mel_cfg)
        else:
            ids = tokenizer_ids(tokenizer)
            self._model = model
            self._frontend = LogMelFrontEnd(mel_cfg)
            self._gen_cfg = BeamSearchConfig(
                num_beams=num_beams,
                max_length=max_length,
                ctc_weight=ctc_weight,
                bos_token_id=ids["bos"],
                eos_token_id=ids["eos"],
                pad_token_id=ids["pad"],
            )

    def _bucket_pad(self, audios: List[np.ndarray]) -> np.ndarray:
        max_len = max(len(a) for a in audios)
        for sec in self.length_buckets:
            cap = int(sec * self.sampling_rate)
            if max_len <= cap:
                max_len = cap
                break
        out = np.zeros((len(audios), max_len), np.float32)
        for i, a in enumerate(audios):
            out[i, : len(a)] = a[:max_len]
        return out

    @torch.inference_mode()
    def _run(self, wav: torch.Tensor, lens: torch.Tensor):
        feats, feat_lens = self._frontend(wav, lens)
        if self.model_type == "aed":
            return generate_joint(self._model, feats, feat_lens, self._gen_cfg,
                                  fused_encoder=self._use_fused, fused=self._fused)
        if self._use_fused:
            out = ctc_infer(self._fused, feats, feat_lens)
        else:
            out = self._model(feats.to(self._dtype), feat_lens)
        return ctc_greedy_decode(out.logits, out.logit_lengths, blank_id=-1)

    def __call__(self, inputs: Union[np.ndarray, Sequence[np.ndarray], Dict]) -> Union[str, List[str]]:
        single = False
        if isinstance(inputs, dict):
            inputs = inputs.get("array", inputs.get("inputs"))
        if isinstance(inputs, np.ndarray) and inputs.ndim == 1:
            inputs, single = [inputs], True
        audios = [np.asarray(a, np.float32) for a in inputs]
        wav = torch.from_numpy(self._bucket_pad(audios)).to(self.device)
        lens = torch.tensor([len(a) for a in audios], dtype=torch.int32, device=self.device)
        if self.model_type == "aed":
            seqs, _ = self._run(wav, lens)
            texts = [self.tokenizer.decode([int(t) for t in row[0]], skip_special_tokens=True)
                     for row in seqs.cpu().numpy()]
        else:
            toks, tlens = self._run(wav, lens)
            texts = [
                self.tokenizer.decode(t, skip_special_tokens=True)
                for t in tokens_to_lists(toks.cpu().numpy(), tlens.cpu().numpy())
            ]
        return texts[0] if single else texts


class EndpointHandler:
    """Inference-endpoint adapter (``{"inputs": ...}`` -> ``{"text": ...}``)."""

    def __init__(self, path: str = "", **kwargs):
        self.pipeline = ASRPipeline(path, **kwargs)

    def __call__(self, data: Dict) -> Dict:
        inputs = data.get("inputs", data)
        if isinstance(inputs, dict) and "array" in inputs:
            inputs = np.asarray(inputs["array"], np.float32)
        return {"text": self.pipeline(inputs)}
