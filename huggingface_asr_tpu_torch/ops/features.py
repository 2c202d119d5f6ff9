"""Waveform -> log-mel front end, plain PyTorch (counterpart of ``huggingface_asr_tpu/ops/features.py``).

Kaldi-compatible 80-dim log-mel fbank as HF ``Speech2TextFeatureExtractor``
computes it: 25 ms povey-windowed frames every 10 ms, per-frame DC removal,
0.97 pre-emphasis, 512-point power spectrum as two DFT matmuls, Kaldi mel
bank (20 Hz .. Nyquist), natural log with a floor, then masked per-utterance
or global CMVN. The bases are built in float64 numpy exactly as the JAX
package builds them and used in float32.

This is the readable reference; ``kernels/mel.py`` holds the folded form that
the CUDA kernel computes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def povey_window(window_length: int = 400) -> np.ndarray:
    """Symmetric povey window: hann(N, sym)**0.85 (Kaldi's default fbank window)."""
    n = np.arange(window_length, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (window_length - 1))
    return np.power(hann, 0.85)


def _hz_to_mel_kaldi(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def kaldi_mel_filter_bank(
    num_frequency_bins: int = 257,
    num_mel_filters: int = 80,
    min_frequency: float = 20.0,
    max_frequency: float = 8000.0,
    sampling_rate: int = 16000,
) -> np.ndarray:
    """Kaldi-style triangular mel filter bank, triangularized in mel space.
    Returns (num_frequency_bins, num_mel_filters), float64."""
    mel_min = _hz_to_mel_kaldi(min_frequency)
    mel_max = _hz_to_mel_kaldi(max_frequency)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    fft_bin_width = sampling_rate / ((num_frequency_bins - 1) * 2)
    fft_freqs = _hz_to_mel_kaldi(fft_bin_width * np.arange(num_frequency_bins))
    fdiff = np.diff(mel_freqs)
    ramps = mel_freqs.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    down_slopes = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    up_slopes = ramps[2:] / fdiff[1:].reshape(-1, 1)
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.T


@dataclasses.dataclass(frozen=True)
class LogMelConfig:
    sampling_rate: int = 16000
    num_mel_bins: int = 80
    frame_length: int = 400  # 25 ms
    hop_length: int = 160  # 10 ms
    fft_length: int = 512
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    mel_floor: float = 1.192092955078125e-07  # 2**-23, HF Speech2Text default
    min_frequency: float = 20.0
    norm_type: str = "utterance"  # "utterance" | "global" | "none"
    normalize_means: bool = True
    normalize_vars: bool = True
    waveform_scale: float = 32768.0
    # The DFT's precision: "highest" (fp32), "high" or "bf16". LogMelFrontEnd
    # here always computes in fp32; kernels/mel.py::MelFrontEnd takes all three.
    matmul_precision: str = "highest"

    @property
    def num_frequency_bins(self) -> int:
        return self.fft_length // 2 + 1

    def num_frames(self, num_samples):
        """1 + floor((S - frame_length) / hop) — center=False framing."""
        return 1 + (num_samples - self.frame_length) // self.hop_length


def _dft_bases(cfg: LogMelConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT bases with zero-padding to fft_length folded in:
    X[k] = sum_{n<frame_length} x[n] exp(-2 pi i k n / fft_length)."""
    n = np.arange(cfg.frame_length, dtype=np.float64).reshape(-1, 1)
    k = np.arange(cfg.num_frequency_bins, dtype=np.float64).reshape(1, -1)
    ang = 2.0 * np.pi * n * k / cfg.fft_length
    return np.cos(ang), -np.sin(ang)


def utterance_cmvn(feats: torch.Tensor, mask: torch.Tensor, cfg: LogMelConfig) -> torch.Tensor:
    """Masked per-utterance CMVN in the JAX op order: the count is clamped at
    1, the variance is divided out as ``/ sqrt(var)`` with no epsilon."""
    m = mask[..., None].to(feats.dtype)
    count = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    if cfg.normalize_means:
        mean = (feats * m).sum(dim=1, keepdim=True) / count
        feats = feats - mean
    if cfg.normalize_vars:
        var = (feats.square() * m).sum(dim=1, keepdim=True) / count
        if not cfg.normalize_means:
            mean = (feats * m).sum(dim=1, keepdim=True) / count
            var = var - mean.square()
        feats = feats / torch.sqrt(var)
    return feats


class LogMelFrontEnd:
    """Batched log-mel extractor.

        fe = LogMelFrontEnd(LogMelConfig())
        feats, feat_lens = fe(waveforms, lengths)   # (B,S),(B,) -> (B,T,80) f32,(B,)
    """

    def __init__(
        self,
        config: LogMelConfig = LogMelConfig(),
        global_means: Optional[np.ndarray] = None,
        global_stds: Optional[np.ndarray] = None,
    ):
        self.config = cfg = config
        window = povey_window(cfg.frame_length)
        cos_b, sin_b = _dft_bases(cfg)
        self._cos = torch.as_tensor(window[:, None] * cos_b, dtype=torch.float32)
        self._sin = torch.as_tensor(window[:, None] * sin_b, dtype=torch.float32)
        self._mel = torch.as_tensor(
            kaldi_mel_filter_bank(
                num_frequency_bins=cfg.num_frequency_bins,
                num_mel_filters=cfg.num_mel_bins,
                min_frequency=cfg.min_frequency,
                max_frequency=cfg.sampling_rate / 2,
                sampling_rate=cfg.sampling_rate,
            ),
            dtype=torch.float32,
        )
        if cfg.norm_type == "global":
            if global_means is None or global_stds is None:
                raise ValueError("norm_type='global' requires global_means/global_stds")
            self._gmeans = torch.as_tensor(np.asarray(global_means), dtype=torch.float32)
            self._gstds = torch.as_tensor(np.asarray(global_stds), dtype=torch.float32)
        else:
            self._gmeans = self._gstds = None

    def __call__(
        self, waveforms: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """waveforms: (B, S) float; lengths: (B,) int samples. Returns
        (features (B, T, num_mel) float32, feat_lengths (B,) int32); padding
        frames are zeroed."""
        cfg = self.config
        if waveforms.ndim == 1:
            waveforms = waveforms[None]
        dev = waveforms.device
        B, S = waveforms.shape
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        x = waveforms.to(torch.float32) * cfg.waveform_scale
        num_frames = int(cfg.num_frames(S))
        frames = x.unfold(1, cfg.frame_length, cfg.hop_length)[:, :num_frames]
        if cfg.remove_dc_offset:
            frames = frames - frames.mean(dim=-1, keepdim=True)
        if cfg.preemphasis:
            first = frames[..., :1] * (1.0 - cfg.preemphasis)
            rest = frames[..., 1:] - cfg.preemphasis * frames[..., :-1]
            frames = torch.cat([first, rest], dim=-1)
        re = frames @ self._cos.to(dev)
        im = frames @ self._sin.to(dev)
        power = re * re + im * im
        mel = power @ self._mel.to(dev)
        log_mel = torch.log(torch.clamp(mel, min=cfg.mel_floor))

        feat_lengths = torch.clamp(cfg.num_frames(lengths.to(torch.int64)), 0, num_frames)
        feat_lengths = feat_lengths.to(torch.int32)
        mask = torch.arange(num_frames, device=dev)[None, :] < feat_lengths[:, None]
        if cfg.norm_type == "utterance":
            log_mel = utterance_cmvn(log_mel, mask, cfg)
        elif cfg.norm_type == "global":
            log_mel = (log_mel - self._gmeans.to(dev)) / self._gstds.to(dev)
        return torch.where(mask[..., None], log_mel, 0.0), feat_lengths


def compute_global_stats(frontend, batches) -> Tuple[np.ndarray, np.ndarray]:
    """Per-mel-bin mean and std over the valid frames of batches of
    ``(waveforms, lengths)`` tensors, summed in float64 (counterpart of
    ``huggingface_asr_tpu/ops/features.py::compute_global_stats``; reference
    compute_dataset_statistics.py:12-24). ``frontend`` computes the log-mel
    without normalization (``norm_type="none"``): this module's
    ``LogMelFrontEnd`` or ``kernels/mel.py::MelFrontEnd`` on the card."""
    n_mel = frontend.config.num_mel_bins
    total = np.zeros(n_mel, dtype=np.float64)
    total_sq = np.zeros_like(total)
    count = 0.0
    for waveforms, lengths in batches:
        feats, feat_lens = frontend(waveforms, lengths)
        feats = feats.to(torch.float64)
        mask = (torch.arange(feats.shape[1], device=feats.device)[None, :] < feat_lens[:, None])[..., None]
        total += (feats * mask).sum(dim=(0, 1)).cpu().numpy()
        total_sq += (feats.square() * mask).sum(dim=(0, 1)).cpu().numpy()
        count += float(mask.sum())
    mean = total / count
    return mean, np.sqrt(total_sq / count - np.square(mean))
