"""Batch assembly: padded fixed-shape numpy batches for the training step
(the port's own copy of ``huggingface_asr_tpu/data/collator.py``; numpy only).

The collator pads raw waveforms (or precomputed mel features) to a quantized
length and tokenizes labels; the log-mel front end and SpecAugment run inside
the training step on the device. Label padding comes with explicit
``label_lengths`` (the CTC loss takes lengths, not -100 sentinels). Rows are
padded by the native assembler (``data/native_collate.py``), as in the JAX
collator.

A data-parallel rank collates only its contiguous rows of a global batch
(``rows=(start, stop)``): every example's waveform and labels are read (a
speed-perturbing transform draws for each of them in order), the rows are
padded to the global batch's quantized length and label width, and the
batch carries ``_rows`` (start, stop, total) and ``_all_lengths`` (every
row's waveform length) for the trainer and the SSL mask draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from huggingface_asr_tpu_torch.data.bucketing import BucketingConfig, quantize_length
from huggingface_asr_tpu_torch.data.native_collate import collate_f32, collate_i32


@dataclasses.dataclass(frozen=True)
class CollatorConfig:
    audio_key: str = "audio"
    text_key: str = "text"
    sampling_rate: int = 16000
    bucketing: BucketingConfig = BucketingConfig()
    label_pad_to_multiple: int = 8
    max_label_length: Optional[int] = None
    # Drop tokens equal to the UNK token from the labels.
    mask_unks: bool = False
    unk_token_id: Optional[int] = None


class SpeechCollator:
    """Assemble examples into fixed-shape batches.

    Examples are dicts with ``audio`` (1-D float array or ``{"array": ...}``)
    and optionally ``text`` (str) or ``labels`` (list of ints). ``tokenizer``
    is any object with ``encode(str) -> ids`` (or that is callable on a
    string and returns ids or ``{"input_ids": ids}``)."""

    def __init__(self, config: CollatorConfig = CollatorConfig(), tokenizer=None,
                 audio_transform=None):
        self.config = config
        self.tokenizer = tokenizer
        # host-side waveform transform, training only
        self.audio_transform = audio_transform

    def _audio_array(self, audio) -> np.ndarray:
        if isinstance(audio, dict):
            audio = audio.get("array", audio)
        arr = np.trim_zeros(np.asarray(audio, dtype=np.float32))
        if self.audio_transform is not None:
            arr = self.audio_transform(arr)
        return arr

    def _encode(self, text: str) -> List[int]:
        tok = self.tokenizer
        ids = tok.encode(text) if hasattr(tok, "encode") else tok(text)
        if isinstance(ids, dict):
            ids = ids["input_ids"]
        if hasattr(ids, "ids"):  # a raw `tokenizers` Encoding
            ids = ids.ids
        if self.config.max_label_length:
            ids = ids[: self.config.max_label_length]
        return list(ids)

    def _labels(self, examples, rows: slice) -> Dict[str, np.ndarray]:
        cfg = self.config
        if all("labels" in e for e in examples):
            label_lists = [list(e["labels"]) for e in examples]
        elif self.tokenizer is not None and all(cfg.text_key in e for e in examples):
            label_lists = [self._encode(e[cfg.text_key]) for e in examples]
        else:
            return {}
        if cfg.mask_unks and cfg.unk_token_id is not None:
            label_lists = [[t for t in ids if t != cfg.unk_token_id] for ids in label_lists]
        m = cfg.label_pad_to_multiple
        L = max(max((len(l) for l in label_lists), default=1), 1)
        labels, label_lengths = collate_i32(label_lists[rows], ((L + m - 1) // m) * m, fill=0)
        return {"labels": labels, "label_lengths": label_lengths}

    def __call__(self, examples: Sequence[Dict[str, Any]],
                 rows: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
        """The batch of ``examples``, or of its rows ``[start, stop)``
        padded as the whole batch would be."""
        # step-delayed transform chains count assembled batches
        if hasattr(self.audio_transform, "advance_batch"):
            self.audio_transform.advance_batch()
        cfg = self.config
        audios = [self._audio_array(e[cfg.audio_key]) for e in examples]
        padded_len = quantize_length(max(len(a) for a in audios), cfg.bucketing)
        part = slice(None) if rows is None else slice(*rows)
        waveforms, lengths = collate_f32(audios[part], padded_len)
        batch = {"input_values": waveforms, "input_values_lengths": lengths, **self._labels(examples, part)}
        if rows is not None:
            batch["_rows"] = np.asarray([rows[0], rows[1], len(examples)], np.int64)
            batch["_all_lengths"] = np.asarray([min(len(a), padded_len) for a in audios], np.int32)
        return batch


class FeatureCollator(SpeechCollator):
    """Variant over precomputed mel features (T, F) instead of waveforms."""

    def __call__(self, examples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        feats = [np.asarray(e["input_features"], dtype=np.float32) for e in examples]
        lengths = np.asarray([f.shape[0] for f in feats], dtype=np.int32)
        padded_len = quantize_length(int(lengths.max()), self.config.bucketing)
        out = np.zeros((len(feats), padded_len, feats[0].shape[1]), dtype=np.float32)
        for i, f in enumerate(feats):
            out[i, : f.shape[0]] = f
        return {"input_features": out, "input_lengths": lengths, **self._labels(examples, slice(None))}
