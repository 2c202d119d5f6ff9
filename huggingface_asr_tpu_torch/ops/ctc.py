"""CTC loss and greedy decoding (counterpart of ``huggingface_asr_tpu/ops/ctc.py``)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from huggingface_asr_tpu_torch.parallel.mesh import global_rows


NO_ALIGNMENT_LOSS = 1e9  # the JAX package's stand-in for -log(0)


def ctc_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = -1,
    reduction: str = "mean",
) -> torch.Tensor:
    """Batched CTC loss in fp32.

    logits: (B, T, V) raw logits; logit_lengths: (B,) valid frames; labels:
    (B, L) target ids without blanks, padded arbitrarily; label_lengths: (B,).
    ``blank_id`` -1 means the last index. ``reduction``: "mean" divides each
    example's loss by ``max(label_length, 1)`` and then averages over the
    batch (the global batch in a data-parallel step, ``parallel/mesh.py``);
    "sum"; "none" gives (B,).

    The recursion is ``F.ctc_loss`` (the JAX package computes its loss outside
    any kernel too). Where no alignment exists (more labels, repeats counted
    twice, than frames) the JAX recursion, which stands -1e9 in for -inf,
    returns 1e9 for that example with finite gradients, so its trainer's guard
    lets the step through on the other examples' gradients. This ends in the
    same place: such an example costs 1e9 and contributes a zero gradient."""
    V = logits.shape[-1]
    if blank_id < 0:
        blank_id = V + blank_id
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, V)
    per_example = F.ctc_loss(
        log_probs, labels.long(), logit_lengths.long(), label_lengths.long(),
        blank=blank_id, reduction="none", zero_infinity=True,
    )
    in_label = torch.arange(1, labels.shape[1], device=labels.device)[None, :] < label_lengths[:, None]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & in_label).sum(dim=1)
    infeasible = label_lengths + repeats > logit_lengths
    per_example = per_example + infeasible.to(per_example.dtype) * NO_ALIGNMENT_LOSS
    if reduction == "none":
        return per_example
    if reduction == "sum":
        return per_example.sum()
    if reduction == "mean":
        # the batch mean over the global batch's rows inside a data-parallel step
        return (per_example / torch.clamp(label_lengths, min=1)).sum() / global_rows(per_example.shape[0])
    raise ValueError(f"unknown reduction {reduction}")


def ctc_forced_alignment_log_prob(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = -1,
) -> torch.Tensor:
    """log P(labels | logits) per example, (B,): the negated per-example
    ``ctc_loss`` (-1e9 where no alignment exists, as in the JAX package)."""
    return -ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id=blank_id, reduction="none")


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
    prev = F.pad(ids[:, :-1], (1, 0), value=blank_id)
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
