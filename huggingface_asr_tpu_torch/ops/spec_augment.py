"""SpecAugment inside the training step (counterpart of
``huggingface_asr_tpu/ops/spec_augment.py``).

Time warp by cubic interpolation around a random centre, N frequency masks,
N time masks with widths absolute or relative to each example's valid length;
padding frames are never touched. Each transform is split into a *draw*
(random integers from a ``torch.Generator`` on the features' device) and an
*apply* (a pure function of the features and the draws), so the apply halves
can be held against the JAX functions on the same draws. The two packages'
random streams differ, so the draws themselves are not comparable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from huggingface_asr_tpu_torch.parallel.mesh import row_draw


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    apply_time_warp: bool = True
    time_warp_window: int = 5
    apply_freq_mask: bool = True
    freq_mask_width_range: Tuple[int, int] = (0, 27)
    num_freq_mask: int = 2
    apply_time_mask: bool = True
    time_mask_width_range: Optional[Tuple[int, int]] = None
    time_mask_width_ratio_range: Optional[Tuple[float, float]] = (0.0, 0.05)
    num_time_mask: int = 5
    replace_with_zero: bool = True


def _randint(gen: torch.Generator, shape, low, high, device) -> torch.Tensor:
    """Integers uniform in [low, high) where the bounds may be tensors that
    broadcast against ``shape``."""
    low = torch.as_tensor(low, device=device)
    high = torch.as_tensor(high, device=device)
    u = row_draw(torch.rand, shape, generator=gen, device=device, dtype=torch.float64)
    span = (high - low).to(torch.float64)
    return low + torch.minimum(torch.floor(u * span), span - 1).to(torch.int64)


def _cubic_kernel(x: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Keys cubic convolution kernel (a = -0.75, the bicubic convention)."""
    ax = x.abs()
    ax2, ax3 = ax * ax, ax * ax * ax
    w1 = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    w2 = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return torch.where(ax <= 1.0, w1, torch.where(ax < 2.0, w2, torch.zeros_like(ax)))


def draw_time_warp(gen: torch.Generator, lengths: torch.Tensor, window: int):
    """Per example: centre ~ U[window, max(length - window, window + 1)),
    warped = centre + U[-window, window) + 1. Returns two (B,) int64 tensors."""
    dev = lengths.device
    B = lengths.shape[0]
    hi = torch.clamp(lengths.to(torch.int64) - window, min=window + 1)
    center = _randint(gen, (B,), window, hi, dev)
    warped = center + _randint(gen, (B,), -window, window, dev) + 1
    return center, warped


def apply_time_warp(x: torch.Tensor, lengths: torch.Tensor, center: torch.Tensor,
                    warped: torch.Tensor, window: int) -> torch.Tensor:
    """Warp (B, T, F) over each example's valid length: the frames left of
    ``warped`` are resampled from [0, centre), the rest from [centre, length),
    cubic taps clamped to their segment. Examples with ``length - window <=
    window`` and all padding frames stay as they are."""
    B, T, _ = x.shape
    xf = x.float()
    o = torch.arange(T, device=x.device, dtype=torch.float32)[None, :]
    length = lengths.to(torch.int64)[:, None]
    center = center.to(torch.int64)[:, None]
    lenf, cf, wf = length.float(), center.float(), warped.float()[:, None]
    # align_corners=False mapping per segment: in = (out + .5) * scale - .5
    left = (o + 0.5) * (cf / torch.clamp(wf, min=1.0)) - 0.5
    right = cf + (o - wf + 0.5) * ((lenf - cf) / torch.clamp(lenf - wf, min=1.0)) - 0.5
    in_left = o < wf
    coords = torch.where(in_left, left, right)
    seg_start = torch.where(in_left, torch.zeros_like(center), center)
    seg_end = torch.where(in_left, center, length)
    base = torch.floor(coords).to(torch.int64)
    out = torch.zeros_like(xf)
    wsum = torch.zeros_like(coords)
    for kk in range(-1, 3):
        tap = base + kk
        w = _cubic_kernel(coords - tap.float())
        tap = torch.clamp(torch.clamp(tap, min=seg_start, max=seg_end - 1), 0, T - 1)
        out = out + w[..., None] * torch.gather(xf, 1, tap[..., None].expand(-1, -1, xf.shape[2]))
        wsum = wsum + w
    out = out / torch.clamp(wsum, min=1e-6)[..., None]
    do_warp = (length - window > window) & (o.to(torch.int64) < length)
    return torch.where(do_warp[..., None], out, xf).to(x.dtype)


def draw_masks(gen: torch.Generator, B: int, num_mask: int, width_min, width_max, size: int, device):
    """Per example ``num_mask`` (position, width) pairs: widths ~ U[width_min,
    max(width_max, width_min + 1)), positions ~ U[0, max(size - max width, 1)).
    The width bounds are ints or (B, 1) tensors. Returns two (B, num_mask) tensors."""
    lo = torch.as_tensor(width_min, device=device).to(torch.int64)
    hi = torch.maximum(torch.as_tensor(width_max, device=device).to(torch.int64), lo + 1)
    widths = _randint(gen, (B, num_mask), lo, hi, device)
    bound = torch.clamp(size - widths.amax(dim=1, keepdim=True), min=1)
    positions = _randint(gen, (B, num_mask), 0, bound, device)
    return positions, widths


def apply_masks(spec: torch.Tensor, positions: torch.Tensor, widths: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero the union of [position, position + width) along ``axis`` (1 time, 2 frequency)."""
    size = spec.shape[axis]
    aran = torch.arange(size, device=spec.device)[None, None, :]
    mask = ((positions[..., None] <= aran) & (aran < (positions + widths)[..., None])).any(dim=1)
    shape = [spec.shape[0], 1, 1]
    shape[axis] = size
    return torch.where(mask.view(shape), torch.zeros((), dtype=spec.dtype, device=spec.device), spec)


def time_mask_width_bounds(lengths: torch.Tensor, config: SpecAugmentConfig):
    """(lo, hi) of the time-mask widths, each (B, 1): absolute, or a ratio of
    each example's VALID length."""
    B = lengths.shape[0]
    if config.time_mask_width_range is not None:
        lo = torch.full((B, 1), config.time_mask_width_range[0], dtype=torch.int64, device=lengths.device)
        hi = torch.full((B, 1), config.time_mask_width_range[1], dtype=torch.int64, device=lengths.device)
        return lo, hi
    rlo, rhi = config.time_mask_width_ratio_range
    lenf = lengths.to(torch.float32)
    lo = torch.floor(lenf * rlo).to(torch.int64)[:, None]
    hi = torch.floor(lenf * rhi).to(torch.int64)[:, None]
    return lo, torch.maximum(hi, lo + 1)


def spec_augment(gen: torch.Generator, features: torch.Tensor, lengths: torch.Tensor,
                 config: SpecAugmentConfig = SpecAugmentConfig()) -> torch.Tensor:
    """SpecAugment on a padded batch (B, T, F) with valid ``lengths``; the
    draws come from ``gen``, which lives on the features' device."""
    B, T, F = features.shape
    dev = features.device
    x = features
    if config.apply_time_warp:
        center, warped = draw_time_warp(gen, lengths, config.time_warp_window)
        x = apply_time_warp(x, lengths, center, warped, config.time_warp_window)
    if config.apply_freq_mask:
        lo, hi = config.freq_mask_width_range
        x = apply_masks(x, *draw_masks(gen, B, config.num_freq_mask, lo, hi, F, dev), axis=2)
    if config.apply_time_mask:
        lo, hi = time_mask_width_bounds(lengths, config)
        x = apply_masks(x, *draw_masks(gen, B, config.num_time_mask, lo, hi, T, dev), axis=1)
    # never put energy into padding frames
    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    return torch.where(valid[:, :, None], x, features)
