"""Waveform -> log-mel with fused utterance CMVN: folded bases, plain version
and CUDA kernels (counterpart of ``huggingface_asr_tpu/ops/pallas_features.py``).

DC removal, pre-emphasis, the povey window and the 2^15 waveform scale are
linear per-frame operators, folded (in float64 numpy, as the JAX package
does) into the cos|sin DFT bases; the all-zero Nyquist bin is dropped. The
kernel (``csrc/mel.cu``) then computes the DFT in fp32 FFMA (register tiles,
each sum in k order as the cuBLAS fp32 product takes it), the power, the mel
product and the log; a second kernel applies utterance CMVN with length
masking and writes bf16 — the input the conv subsampler takes.

``MelFrontEnd`` is the counterpart of ``PallasLogMelFrontEnd``; the plain
``ops/features.py::LogMelFrontEnd`` computes the same features unfolded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.ops.features import (
    LogMelConfig,
    _dft_bases,
    kaldi_mel_filter_bank,
    povey_window,
    utterance_cmvn,
)

BF16, F32 = torch.bfloat16, torch.float32


def folded_bases(cfg: LogMelConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(dft', mel'): dft' is (frame_length, 2*(bins-1)) = scale * M^T diag(w) [C|S]
    with M = pre-emphasis @ DC removal and the Nyquist bin dropped; mel' is
    (bins-1, num_mel). Built in float64, returned float32."""
    L = cfg.frame_length
    cos_b, sin_b = _dft_bases(cfg)
    w = povey_window(L)
    wc = w[:, None] * cos_b
    ws = w[:, None] * sin_b
    p = cfg.preemphasis
    P = np.eye(L)
    if p:
        P[0, 0] = 1.0 - p
        for n in range(1, L):
            P[n, n - 1] = -p
    D = np.eye(L) - np.full((L, L), 1.0 / L) if cfg.remove_dc_offset else np.eye(L)
    M = (P @ D) if cfg.remove_dc_offset or p else np.eye(L)
    mel = kaldi_mel_filter_bank(
        num_frequency_bins=cfg.num_frequency_bins,
        num_mel_filters=cfg.num_mel_bins,
        min_frequency=cfg.min_frequency,
        max_frequency=cfg.sampling_rate / 2,
        sampling_rate=cfg.sampling_rate,
    )
    if np.abs(mel[-1]).max() != 0.0:
        raise NotImplementedError("the folded front end requires a zero-weight Nyquist mel row")
    dft = np.concatenate([M.T @ wc[:, :-1], M.T @ ws[:, :-1]], axis=1)
    return (
        np.ascontiguousarray(dft * np.float32(cfg.waveform_scale), dtype=np.float32),
        np.ascontiguousarray(mel[:-1], dtype=np.float32),
    )


def log_mel_plain(wav: torch.Tensor, n_frames: int, dft: torch.Tensor, mel: torch.Tensor,
                  hop: int, floor: float) -> torch.Tensor:
    """wav (B, S) f32 -> (B, n_frames, n_mel) f32 log-mel from the folded bases."""
    L, two_nb = dft.shape
    nb = two_nb // 2
    frames = wav.unfold(1, L, hop)[:, :n_frames]
    coef = frames @ dft
    power = coef[..., :nb] ** 2 + coef[..., nb:] ** 2
    return torch.log(torch.clamp(power @ mel, min=floor))


MEL_PASS_BINS, MEL_MAX_BINS = 64, 80  # the kernel's bins a pass; mel columns its threads hold


def log_mel(wav: torch.Tensor, n_frames: int, dft: torch.Tensor, mel: torch.Tensor,
            hop: int, floor: float) -> torch.Tensor:
    """``log_mel_plain``; CUDA tensors run ``csrc/mel.cu::mel_kernel`` (any S;
    bins in passes of 64, at most 80 mel bins)."""
    if not _build.on_cuda(wav, dft, mel):
        return log_mel_plain(wav, n_frames, dft, mel, hop, floor)
    B, S = wav.shape
    L, two_nb = dft.shape
    nb, n_mel = mel.shape
    if two_nb != 2 * nb:
        raise ValueError("dft must have 2 * bins columns")
    if nb % MEL_PASS_BINS or n_mel > MEL_MAX_BINS:
        raise ValueError(f"the mel kernel takes bins in passes of {MEL_PASS_BINS} and at most {MEL_MAX_BINS} "
                         f"mel bins, got {nb} and {n_mel}")
    if n_frames < 1 or n_frames > 1 + (S - L) // hop:
        raise ValueError(f"{n_frames} frames need more than {S} samples")
    _build.check(wav, "wav", F32)
    _build.check(dft, "dft", F32)
    _build.check(mel, "mel", F32)
    out = torch.empty(B, n_frames, n_mel, dtype=F32, device=wav.device)
    _build.launch("asr_log_mel", "ppppiiiiiiif", wav.data_ptr(), dft.data_ptr(), mel.data_ptr(),
                  out.data_ptr(), B, S, n_frames, L, hop, nb, n_mel, float(floor))
    return out


def cmvn_plain(lm: torch.Tensor, lengths: torch.Tensor, norm_means: bool = True,
               norm_vars: bool = True) -> torch.Tensor:
    """Masked utterance CMVN of (B, T, n_mel) f32 -> bf16, rows >= length zero."""
    cfg = LogMelConfig(normalize_means=norm_means, normalize_vars=norm_vars)
    mask = torch.arange(lm.shape[1], device=lm.device)[None, :] < lengths[:, None]
    return torch.where(mask[..., None], utterance_cmvn(lm, mask, cfg), 0.0).to(BF16)


def cmvn(lm: torch.Tensor, lengths: torch.Tensor, norm_means: bool = True,
         norm_vars: bool = True) -> torch.Tensor:
    """``cmvn_plain``; CUDA tensors run ``csrc/mel.cu::cmvn_kernel``."""
    if not _build.on_cuda(lm, lengths):
        return cmvn_plain(lm, lengths, norm_means, norm_vars)
    B, T, n_mel = lm.shape
    _build.check(lm, "lm", F32)
    _build.check(lengths, "lengths", torch.int32, (B,))
    out = torch.empty(B, T, n_mel, dtype=BF16, device=lm.device)
    _build.launch("asr_cmvn", "pppiiiii", lm.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  B, T, n_mel, int(norm_means), int(norm_vars))
    return out


class MelFrontEnd:
    """Counterpart of ``PallasLogMelFrontEnd``: with ``norm_type="utterance"``
    (``fused_cmvn_bf16=True``) log-mel in the first kernel, utterance CMVN and
    length masking in the second, bf16 features out; with ``"none"``
    (``fused_cmvn_bf16=False``) the log-mel kernel alone, fp32 out, padding
    frames zeroed. Global CMVN stays on ``ops.features.LogMelFrontEnd``, as
    in JAX. The bases live on ``device``, folded once here.
    """

    def __init__(self, config: LogMelConfig = LogMelConfig(), device=None):
        if config.norm_type not in ("utterance", "none"):
            raise NotImplementedError(
                f"norm_type={config.norm_type!r}: use ops.features.LogMelFrontEnd")
        self.config = config
        dft, mel = folded_bases(config)
        self.dft = torch.as_tensor(dft, device=device)
        self.mel = torch.as_tensor(mel, device=device)

    def __call__(self, waveforms: torch.Tensor, lengths: Optional[torch.Tensor] = None, *,
                 plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """waveforms (B, S) -> (features (B, T, n_mel) bf16, or fp32 without
        CMVN, frame lengths (B,) int32). ``plain=True`` runs the plain
        versions on any device."""
        cfg = self.config
        if waveforms.ndim == 1:
            waveforms = waveforms[None]
        B, S = waveforms.shape
        dev = waveforms.device
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        n_frames = int(cfg.num_frames(S))
        feat_lengths = torch.clamp(cfg.num_frames(lengths.to(torch.int64)), 0, n_frames)
        feat_lengths = feat_lengths.to(torch.int32)
        wav = waveforms.to(F32).contiguous()
        mel_fn, cmvn_fn = (log_mel_plain, cmvn_plain) if plain else (log_mel, cmvn)
        lm = mel_fn(wav, n_frames, self.dft, self.mel, cfg.hop_length, cfg.mel_floor)
        if cfg.norm_type == "none":
            mask = torch.arange(n_frames, device=dev)[None, :] < feat_lengths[:, None]
            return torch.where(mask[..., None], lm, 0.0), feat_lengths
        return cmvn_fn(lm, feat_lengths, cfg.normalize_means, cfg.normalize_vars), feat_lengths
