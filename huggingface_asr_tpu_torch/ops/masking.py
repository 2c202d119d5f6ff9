"""Span mask sampling for SSL pretraining, host-side numpy (counterpart of
``huggingface_asr_tpu/ops/masking.py``, of which this is a copy).

HF's ``_compute_mask_indices`` / ``_sample_negative_indices`` as the
reference pretraining collator uses them: SpecAugment-style span masks over
encoder frames, and uniform negative sampling from other masked positions.
They run in the input pipeline, once a batch. With the same
``np.random.default_rng`` state both packages draw the same masks and
negatives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def compute_mask_indices(
    shape: Tuple[int, int],
    mask_prob: float,
    mask_length: int,
    lengths: Optional[np.ndarray] = None,
    min_masks: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Sample boolean span masks (B, T): ~mask_prob of frames covered by
    spans of ``mask_length``, at least ``min_masks`` spans per example."""
    rng = rng or np.random.default_rng()
    B, T = shape
    lengths = np.full(B, T) if lengths is None else np.asarray(lengths)
    mask = np.zeros((B, T), dtype=bool)
    for b in range(B):
        L = int(lengths[b])
        if L < mask_length + 1:
            continue
        num_spans = int(mask_prob * L / mask_length + rng.random())
        num_spans = max(num_spans, min_masks)
        num_spans = min(num_spans, L // mask_length)
        if num_spans == 0:
            continue
        starts = rng.choice(L - mask_length, size=num_spans, replace=False)
        for s in starts:
            mask[b, s : s + mask_length] = True
    return mask


def sample_negative_indices(
    mask: np.ndarray,
    num_negatives: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """For each (b, t), sample ``num_negatives`` indices of OTHER masked
    positions in the same example (flat time indices). Shape (B, T, N)."""
    rng = rng or np.random.default_rng()
    B, T = mask.shape
    out = np.zeros((B, T, num_negatives), dtype=np.int64)
    for b in range(B):
        masked_pos = np.flatnonzero(mask[b])
        n = len(masked_pos)
        if n <= 1:
            continue
        for t_i, t in enumerate(masked_pos):
            # sample from masked positions excluding t
            cand = rng.integers(0, n - 1, size=num_negatives)
            cand[cand >= t_i] += 1
            out[b, t] = masked_pos[cand]
    return out
