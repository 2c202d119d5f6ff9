"""Streaming recognition sessions for causal models (counterpart of
``huggingface_asr_tpu/serving/streaming.py``).

Feed audio chunks, get the transcription so far. A causal model's output at
frame t never depends on frames after t, so re-running the forward over the
accumulated prefix (padded to one of a few bucket lengths) gives at every feed
exactly the prefix of the final transcript: emitted tokens never retract.
Audio past the last bucket is left out, as the JAX sessions clamp it.

Exact prefix stability also needs a streaming-safe normalisation: a
``LogMelFrontEnd`` with ``norm_type="global"`` (fixed per-bin statistics).
Per-utterance CMVN recomputes its statistics over the growing prefix, which
moves earlier frames' features between feeds.

Both sessions run the plain model eagerly on the session's device (the
card unless ``device="cpu"``): a causal model takes no kernel of the fused
path, in the JAX package either. The model computes in the dtype of its
parameters (a CTC model) or its ``dtype`` (a joint model).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from huggingface_asr_tpu_torch.decoding.generate import generate_joint
from huggingface_asr_tpu_torch.ops.ctc import ctc_greedy_decode
from huggingface_asr_tpu_torch.utils.device import resolve_device

BUCKET_SECONDS = (2, 4, 8, 15, 22, 30)


class _Session:
    """The audio buffer and its bucketing, shared by both sessions."""

    def __init__(self, frontend, tokenizer, sampling_rate: int, bucket_seconds: Sequence[float], device):
        self._frontend = frontend
        self._tokenizer = tokenizer
        self._sr = sampling_rate
        self._buckets = [int(s * sampling_rate) for s in bucket_seconds]
        self._audio = np.zeros(0, np.float32)
        self.device = resolve_device(device)

    def _bucketed(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _features(self, chunk: np.ndarray):
        """Append ``chunk``; the features of the buffered audio (at most the
        last bucket's worth), zero-padded to its bucket."""
        self._audio = np.concatenate([self._audio, np.asarray(chunk, np.float32)])
        n = min(len(self._audio), self._buckets[-1])
        wav = np.zeros((1, self._bucketed(n)), np.float32)
        wav[0, :n] = self._audio[:n]
        wav_t = torch.from_numpy(wav).to(self.device)
        return self._frontend(wav_t, torch.tensor([n], dtype=torch.int32, device=self.device))

    def reset(self) -> None:
        self._audio = np.zeros(0, np.float32)


class StreamingCTCSession(_Session):
    """Greedy CTC decoding of a causal ``EBranchformerForCTC`` over the audio so far."""

    def __init__(self, model, frontend, tokenizer=None, sampling_rate: int = 16000,
                 bucket_seconds: Sequence[float] = BUCKET_SECONDS, device="cuda"):
        if not model.config.is_causal:
            raise ValueError("streaming requires an is_causal model")
        super().__init__(frontend, tokenizer, sampling_rate, bucket_seconds, device)
        self._model = model.to(self.device).eval()
        self._dtype = next(model.parameters()).dtype

    @torch.inference_mode()
    def feed(self, chunk: np.ndarray) -> List[int]:
        """Append audio; return the current full token sequence."""
        feats, flens = self._features(chunk)
        out = self._model(feats.to(self._dtype), flens)
        toks, tlens = ctc_greedy_decode(out.logits, out.logit_lengths, blank_id=-1)
        return [int(t) for t in toks[0, : int(tlens[0])].tolist()]

    def transcript(self, tokens: Optional[List[int]] = None) -> str:
        if tokens is None:
            tokens = self.feed(np.zeros(0, np.float32))
        if self._tokenizer is None:
            return " ".join(map(str, tokens))
        return self._tokenizer.decode(tokens, skip_special_tokens=True)


class StreamingJointSession(_Session):
    """Joint CTC/attention decoding of a causal ``JointCTCAttentionEncoderDecoder``:
    each feed runs the encoder and ``generate_joint``'s beam search over the
    audio so far, so it returns exactly the whole decode of that audio (the
    incremental scorer, ``CTCPrefixScorer.extended`` / ``replay_state`` /
    ``extend_state``, is there for frame-synchronous integrations)."""

    def __init__(self, model, frontend, gen_config, tokenizer=None, sampling_rate: int = 16000,
                 bucket_seconds: Sequence[float] = BUCKET_SECONDS, device="cuda"):
        if not model.config.encoder.is_causal:
            raise ValueError("streaming requires is_causal")
        super().__init__(frontend, tokenizer, sampling_rate, bucket_seconds, device)
        self._model = model.to(self.device).eval()
        self._gen_config = gen_config

    @torch.inference_mode()
    def feed(self, chunk: np.ndarray) -> List[int]:
        """Append audio; return the current best hypothesis's token ids
        (bos, eos and pad left out)."""
        feats, flens = self._features(chunk)
        seqs, _ = generate_joint(self._model, feats, flens, self._gen_config)
        cfg = self._gen_config
        specials = {cfg.bos_token_id, cfg.eos_token_id, cfg.pad_token_id}
        return [int(t) for t in seqs[0, 0].tolist() if int(t) not in specials]

    def transcript(self, tokens: Optional[List[int]] = None) -> str:
        if tokens is None:
            tokens = self.feed(np.zeros(0, np.float32))
        if self._tokenizer is None:
            raise ValueError("transcript needs the session's tokenizer")
        return self._tokenizer.decode(tokens, skip_special_tokens=True)
