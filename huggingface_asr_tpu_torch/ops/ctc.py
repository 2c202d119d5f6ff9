"""CTC greedy decoding (counterpart of ``huggingface_asr_tpu/ops/ctc.py:147,175``)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def ctc_greedy_decode(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    blank_id: int = -1,
    pad_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy CTC collapse on the device.

    Returns (tokens (B, T) left-compacted and padded with ``pad_id``,
    token_lengths (B,)).
    """
    B, T, V = logits.shape
    if blank_id < 0:
        blank_id = V + blank_id
    ids = logits.argmax(dim=-1).to(torch.int32)  # (B, T)
    prev = torch.nn.functional.pad(ids[:, :-1], (1, 0), value=blank_id)
    valid_t = torch.arange(T, device=logits.device)[None, :] < logit_lengths[:, None]
    keep = (ids != blank_id) & (ids != prev) & valid_t
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    pos = torch.where(keep, pos, T)  # dropped tokens land past the end
    out = torch.full((B, T + 1), pad_id, dtype=torch.int32, device=logits.device)
    out.scatter_(1, pos, ids)
    lengths = keep.sum(dim=1).to(torch.int32)
    return out[:, :T], lengths


def tokens_to_lists(tokens: np.ndarray, lengths: np.ndarray) -> List[List[int]]:
    """Host-side: convert padded (B, T) + lengths into ragged python lists."""
    return [list(map(int, tokens[b, : int(lengths[b])])) for b in range(tokens.shape[0])]
