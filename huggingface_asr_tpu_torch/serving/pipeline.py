"""Serving: ASR pipeline + inference-endpoint handler
(counterpart of ``huggingface_asr_tpu/serving/pipeline.py``, CTC path).

waveform(s) -> log-mel -> E-Branchformer CTC -> greedy collapse -> text.
Inputs are padded up to the next of a few length buckets, so a server sees
a handful of shapes. The pipeline runs on the card unless the caller passes
``device="cpu"``; without a card the default raises. On a CUDA device with a
bf16 model that the fused path supports, the front end, subsampler and
encoder layers run the CUDA kernels (``kernels/``); otherwise the plain float
model runs.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from huggingface_asr_tpu_torch.kernels.mel import MelFrontEnd
from huggingface_asr_tpu_torch.models.configs import parse_dtype
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer, fused_encoder_refusal
from huggingface_asr_tpu_torch.ops.ctc import ctc_greedy_decode, tokens_to_lists
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
from huggingface_asr_tpu_torch.training.model_factory import load_ctc_model
from huggingface_asr_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class ASRPipeline:
    """``tokenizer`` is an object with ``decode(ids, skip_special_tokens=True)``;
    without one, an HF tokenizer is loaded from ``tokenizer_dir`` (or the
    model directory) through ``transformers``."""

    def __init__(
        self,
        model_dir: str,
        tokenizer_dir: Optional[str] = None,
        model_type: str = "ctc",
        dtype: str = "bfloat16",
        length_buckets: Sequence[float] = (2.0, 5.0, 10.0, 20.0, 30.0),
        sampling_rate: int = 16000,
        device: Union[str, torch.device] = "cuda",
        tokenizer=None,
    ):
        if model_type != "ctc":
            raise NotImplementedError(f"model_type={model_type!r} is not ported yet (AED slice)")
        self.device = resolve_device(device)
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(tokenizer_dir or model_dir)
        self.tokenizer = tokenizer
        self.sampling_rate = sampling_rate
        self.length_buckets = sorted(length_buckets)
        dt = parse_dtype(dtype)

        model = load_ctc_model(model_dir, self.device)
        config = model.config
        refusal = fused_encoder_refusal(config, dt)
        self._use_fused = self.device.type == "cuda" and refusal is None
        if self.device.type == "cuda" and refusal is not None:
            logger.warning("serving through the plain model, not the fused kernels: %s", refusal)
        mel_cfg = LogMelConfig(num_mel_bins=config.num_fbanks)
        if self._use_fused:
            self._fused = FusedCTC(model, self.device)
            self._frontend = MelFrontEnd(mel_cfg, device=self.device)
        else:
            self._model = model.to(dt)
            self._dtype = dt
            self._frontend = LogMelFrontEnd(mel_cfg)

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
