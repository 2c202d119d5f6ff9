"""Waveform -> log-mel with fused utterance CMVN: folded bases, plain version
and CUDA kernels (counterpart of ``huggingface_asr_tpu/ops/pallas_features.py``).

DC removal, pre-emphasis, the povey window and the 2^15 waveform scale are
linear per-frame operators, folded (in float64 numpy, as the JAX package
does) into the cos|sin DFT bases; the all-zero Nyquist bin is dropped. The
DFT runs in one of the TPU kernel's three modes (``LogMelConfig.
matmul_precision``, ``MEL_MODES``):

* ``"highest"``: fp32. ``csrc/mel.cu`` computes it in fp32 FFMA (register
  tiles, each sum in k order as the cuBLAS fp32 product takes it);
* ``"bf16"``: one bf16 product, ``bf16(waveform) @ bf16(bases)`` with fp32
  sums (the JAX serving path's front end);
* ``"high"``: three bf16 products, ``hi.hi + hi.lo + lo.hi`` of the split
  operands (``_split_hi_lo``), the lo.lo term dropped.

The last two run ``csrc/mel_bf16.cu`` (wgmma on the tensor cores, the bases
through a TMA ring, each bin's cos and sin in adjacent columns); their plain
version takes the products band by band, in the TPU kernel's order (hop-row
bands of ``hop`` samples). Then the power, the mel product and the log: the
bf16 kernel sums each filter over its own run of nonzero bins (``mel_bands``),
which gives the dense in-order sum's bits. It keeps the power of two passes
of 64 bins, so a run that spans more is summed in segments, each within two
passes, the partial sums carried from one to the next: any bank whose filters
are each one contiguous run, at any count up to ``MEL_MAX_BINS``, the Kaldi
bank at every count from 1 to 128 among them (``mel_bins_refusal``). A second
kernel applies utterance CMVN with length masking and writes bf16 — the input
the conv subsampler takes.

``MelFrontEnd`` is the counterpart of ``PallasLogMelFrontEnd``; the plain
``ops/features.py::LogMelFrontEnd`` computes the same features unfolded.
"""

from __future__ import annotations

import functools
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
MEL_MODES = ("highest", "high", "bf16")
MEL_PASS_BINS, MEL_MAX_BINS = 64, 128  # the kernels' bins a pass; the most mel bins they take (any count up to it)
# flags of a segment row's last field (``mel_bands``), above the filter's index and its carry slot
MEL_CARRY_IN, MEL_CARRY_OUT = 1 << 16, 1 << 17


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
    mel = folded_bank(cfg)
    dft = np.concatenate([M.T @ wc[:, :-1], M.T @ ws[:, :-1]], axis=1)
    return np.ascontiguousarray(dft * np.float32(cfg.waveform_scale), dtype=np.float32), mel


def folded_bank(cfg: LogMelConfig) -> np.ndarray:
    """``folded_bases``' mel' alone: (bins-1, num_mel) float32."""
    mel = kaldi_mel_filter_bank(
        num_frequency_bins=cfg.num_frequency_bins,
        num_mel_filters=cfg.num_mel_bins,
        min_frequency=cfg.min_frequency,
        max_frequency=cfg.sampling_rate / 2,
        sampling_rate=cfg.sampling_rate,
    )
    if np.abs(mel[-1]).max() != 0.0:
        raise NotImplementedError("the folded front end requires a zero-weight Nyquist mel row")
    return np.ascontiguousarray(mel[:-1], dtype=np.float32)


def _split_hi_lo(a: torch.Tensor):
    """(hi, lo) bf16: hi = a rounded to nearest even, lo = bf16(a - hi)
    (``pallas_features.py::_split_hi_lo``)."""
    hi = a.to(BF16)
    return hi, (a - hi.to(F32)).to(BF16)


def split_bases(dft: np.ndarray, mode: str) -> torch.Tensor:
    """The bf16 bases of ``mode`` as the kernel reads them: (P, 2*bins, L),
    a row per output column, P = 1 (hi) for "bf16", 2 (hi, lo) for "high".
    Row 2n is bin n's cos column of ``dft``, row 2n + 1 its sin column, so
    that the two land in one thread's accumulator pair."""
    nb = dft.shape[1] // 2
    order = np.stack([np.arange(nb), nb + np.arange(nb)], axis=1).reshape(-1)
    hi, lo = _split_hi_lo(torch.as_tensor(dft[:, order], dtype=F32).t().contiguous())
    return torch.stack([hi] if mode == "bf16" else [hi, lo])


def mel_bands(mel: np.ndarray) -> np.ndarray:
    """The bank's filters as the bf16 kernel reads them: (n_rows + passes, 4)
    int32, passes = ceil(bins / 64). The kernel keeps the power of the last
    two passes of 64 bins, so each filter's run of nonzero bins is cut into
    segments that each lie within the pass in which they end and the one
    before it: one where the run does (every filter of the Kaldi bank from 12
    bins up), else from the run's end back, a segment a pair of passes. Row r
    < n_rows: a segment's (first bin, width, offset of its weights among all
    the bank's nonzeros, tag); the rows are ordered by the pass in which the
    segment ends (an all-zero filter, of width 0, in the first), filter order
    within a pass, and a filter's offsets follow its bins, the filters' in
    filter order. The tag is the filter's index, and for a filter of
    more than one segment also its carry slot (the count of such filters
    before it) times 256, ``MEL_CARRY_IN`` where the segment starts from the
    one before's sums and ``MEL_CARRY_OUT`` where it hands its sums on rather
    than storing the log: each filter stays one sum in bin order. Row n_rows
    + p: (the first row of pass p's segments, their count, 0, 0). Where no
    run spans more than two passes, n_rows = n_mel and the rows are those of
    the one-segment table. Raises if a filter's nonzeros are not one
    contiguous run, or past ``MEL_MAX_BINS`` filters."""
    nb, n_mel = mel.shape
    if n_mel > MEL_MAX_BINS:
        raise ValueError(f"{n_mel} mel filters: the bf16 kernel takes at most MEL_MAX_BINS = {MEL_MAX_BINS}")
    passes = -(-nb // MEL_PASS_BINS)
    rows, off, slots = [], 0, 0
    for m in range(n_mel):
        nz = np.flatnonzero(mel[:, m])
        if nz.size and nz[-1] - nz[0] + 1 != nz.size:
            raise ValueError(f"mel filter {m} has nonzero weights at bins {nz.tolist()}: not one contiguous run")
        first, width = (int(nz[0]), int(nz.size)) if nz.size else (0, 0)
        last = first + width - 1
        segments = []  # (end pass, first bin, width), from the run's end back
        while True:
            end_pass = last // MEL_PASS_BINS if width else 0
            start = max(first, MEL_PASS_BINS * (end_pass - 1))
            segments.append((end_pass, start, last - start + 1 if width else 0))
            if start == first:
                break
            last = start - 1
        segments.reverse()
        slot = slots << 8 if len(segments) > 1 else 0
        slots += len(segments) > 1
        for k, (end_pass, start, w) in enumerate(segments):
            flags = (MEL_CARRY_IN if k else 0) | (MEL_CARRY_OUT if k + 1 < len(segments) else 0)
            rows.append((end_pass, m, start, w, off + start - first, m | slot | flags))
        off += width
    rows.sort()
    table = np.zeros((len(rows) + passes, 4), np.int32)
    for r, (_, _, start, w, o, tag) in enumerate(rows):
        table[r] = (start, w, o, tag)
    ends = np.asarray([row[0] for row in rows])
    for p in range(passes):
        table[len(rows) + p] = (int(np.searchsorted(ends, p)), int((ends == p).sum()), 0, 0)
    return table


def mel_kernel_table(mel: np.ndarray) -> np.ndarray:
    """What ``csrc/mel_bf16.cu`` reads of the bank, one int32 array of rows of
    4: ``mel_bands``' rows, then the filters' nonzero weights in filter order
    (each segment's at its row's offset), fp32 bits, four a row, the last row
    padded with zeros."""
    return _kernel_table(mel)[0]


def _kernel_table(mel: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """(``mel_kernel_table``, n_rows, carry slots): the table and what the
    kernel's entry takes beside it."""
    bands = mel_bands(mel)
    nb, n_mel = mel.shape
    n_rows = bands.shape[0] - -(-nb // MEL_PASS_BINS)
    tags = bands[:n_rows, 3]
    weights = np.zeros(-(-int(bands[:n_rows, 1].sum()) // 4) * 4, np.float32)
    for first, width, off, tag in bands[:n_rows]:
        weights[off:off + width] = mel[first:first + width, tag & 0xFF]
    slots = len({int(t) >> 8 & 0xFF for t in tags if t & MEL_CARRY_OUT})
    return np.concatenate([bands, weights.view(np.int32).reshape(-1, 4)]), n_rows, slots


@functools.lru_cache(maxsize=None)
def mel_bins_refusal(num_mel_bins: int) -> Optional[str]:
    """Why the log-mel kernels do not take the bank that a front end of
    ``num_mel_bins`` builds (``LogMelConfig``'s other fields as the serving
    and evaluate routes leave them), as a parenthesis for the gates'
    sentences, or None: past ``MEL_MAX_BINS``, or a bank whose bf16 table
    ``mel_bands`` refuses. Every count from 1 to 128 builds today; the check
    keeps a change of the bank from reaching a request."""
    if num_mel_bins > MEL_MAX_BINS:
        return f"(the log-mel and CMVN kernels take at most MEL_MAX_BINS = {MEL_MAX_BINS} mel bins)"
    try:
        mel_bands(folded_bank(LogMelConfig(num_mel_bins=num_mel_bins)))
    except ValueError as e:
        return f"(the bf16 log-mel kernel does not take its bank: {e})"
    return None


def _kernel_table_of(mel: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """(``mel_kernel_table``, n_rows, carry slots) of a bank on the card,
    made at the bank's first use (a copy to the host) and kept on the tensor
    until it is written in place."""
    kept = getattr(mel, "_asr_mel_table", None)
    if kept is None or kept[0] != mel._version:
        table, n_rows, slots = _kernel_table(mel.detach().cpu().numpy())
        kept = (mel._version, (torch.from_numpy(table).to(mel.device), n_rows, slots))
        mel._asr_mel_table = kept
    return kept[1]


def _check_mode(mode: str) -> str:
    if mode not in MEL_MODES:
        raise ValueError(f"matmul_precision {mode!r}: the log-mel front end takes {MEL_MODES}")
    return mode


def _round(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).to(x.dtype)


def log_mel_plain(wav: torch.Tensor, n_frames: int, dft: torch.Tensor, mel: torch.Tensor,
                  hop: int, floor: float, mode: str = "highest") -> torch.Tensor:
    """wav (B, S) f32 -> (B, n_frames, n_mel) f32 log-mel from the folded bases:
    ``dft`` (L, 2*bins) fp32 for "highest", ``split_bases``' (P, 2*bins, L)
    bf16 (each bin's cos and sin in adjacent rows) for "bf16" and "high",
    whose products are taken band by band (``hop`` samples of the frame
    each), every product with fp32 sums, as the TPU kernel takes them
    (pallas_features.py:129-158)."""
    if _check_mode(mode) == "highest":
        L, two_nb = dft.shape
    else:
        two_nb, L = dft.shape[1:]
    nb = two_nb // 2
    frames = wav.unfold(1, L, hop)[:, :n_frames]
    if mode == "highest":
        coef = frames @ dft
    else:
        x_hi = _round(frames)
        x_lo = _round(frames - x_hi)
        hi = dft[0].to(frames.dtype).t()
        lo = dft[1].to(frames.dtype).t() if mode == "high" else None
        coef = None
        for j in range(0, L, hop):
            band = slice(j, min(j + hop, L))
            part = x_hi[..., band] @ hi[band]
            if mode == "high":
                part = part + x_hi[..., band] @ lo[band] + x_lo[..., band] @ hi[band]
            coef = part if coef is None else coef + part
    if mode == "highest":
        power = coef[..., :nb] ** 2 + coef[..., nb:] ** 2
    else:
        power = coef[..., 0::2] ** 2 + coef[..., 1::2] ** 2
    return torch.log(torch.clamp(power @ mel, min=floor))


def log_mel(wav: torch.Tensor, n_frames: int, dft: torch.Tensor, mel: torch.Tensor,
            hop: int, floor: float, mode: str = "highest") -> torch.Tensor:
    """``log_mel_plain``; CUDA tensors run ``csrc/mel.cu::mel_kernel`` ("highest")
    or ``csrc/mel_bf16.cu`` ("bf16", "high"; counted as ``asr_log_mel_bf16``
    and ``asr_log_mel_high``): any S, bins in passes of 64, any count of mel
    bins up to ``MEL_MAX_BINS``; the bf16 kernel also needs L and hop
    multiples of 16 and each filter's nonzeros contiguous (``mel_bands``)."""
    if not _build.on_cuda(wav, dft, mel):
        return log_mel_plain(wav, n_frames, dft, mel, hop, floor, mode)
    if _check_mode(mode) != "highest":
        return _log_mel_bf16(wav, n_frames, dft, mel, hop, floor, mode)
    B, S = wav.shape
    L, two_nb = dft.shape
    nb, n_mel = mel.shape
    if two_nb != 2 * nb:
        raise ValueError("dft must have 2 * bins columns")
    if nb % MEL_PASS_BINS or n_mel > MEL_MAX_BINS:
        raise ValueError(f"the mel kernel takes bins in passes of {MEL_PASS_BINS} and at most MEL_MAX_BINS = "
                         f"{MEL_MAX_BINS} mel bins, got {nb} and {n_mel}")
    if n_frames < 1 or n_frames > 1 + (S - L) // hop:
        raise ValueError(f"{n_frames} frames need more than {S} samples")
    _build.check(wav, "wav", F32)
    _build.check(dft, "dft", F32)
    _build.check(mel, "mel", F32)
    out = torch.empty(B, n_frames, n_mel, dtype=F32, device=wav.device)
    _build.launch("asr_log_mel", "ppppiiiiiiif", wav.data_ptr(), dft.data_ptr(), mel.data_ptr(),
                  out.data_ptr(), B, S, n_frames, L, hop, nb, n_mel, float(floor))
    return out


def _log_mel_bf16(wav, n_frames, dft, mel, hop, floor, mode):
    B, S = wav.shape
    P, two_nb, L = dft.shape
    nb, n_mel = mel.shape
    if P != (2 if mode == "high" else 1) or two_nb != 2 * nb:
        raise ValueError(f"dft must be ({2 if mode == 'high' else 1}, 2 * bins, L) for {mode!r}, "
                         f"got {tuple(dft.shape)}")
    if nb % MEL_PASS_BINS or n_mel > MEL_MAX_BINS or L % 16 or hop % 16:
        raise ValueError(f"the bf16 mel kernel takes bins in passes of {MEL_PASS_BINS}, at most MEL_MAX_BINS = "
                         f"{MEL_MAX_BINS} mel bins, and L and hop multiples of 16, got {nb}, {n_mel}, {L} and {hop}")
    if n_frames < 1 or n_frames > 1 + (S - L) // hop:
        raise ValueError(f"{n_frames} frames need more than {S} samples")
    _build.check(wav, "wav", F32)
    _build.check(dft, "dft", BF16)
    _build.check(mel, "mel", F32)
    table, n_rows, slots = _kernel_table_of(mel)
    out = torch.empty(B, n_frames, n_mel, dtype=F32, device=wav.device)
    _build.launch("asr_log_mel_bf16", "pppiiipiiiiiiifi", wav.data_ptr(), dft.data_ptr(), table.data_ptr(),
                  table.shape[0], n_rows, slots, out.data_ptr(), B, S, n_frames, L, hop, nb, n_mel, float(floor),
                  int(mode == "high"), label=f"asr_log_mel_{mode}")
    return out


def cmvn_plain(lm: torch.Tensor, lengths: torch.Tensor, norm_means: bool = True,
               norm_vars: bool = True) -> torch.Tensor:
    """Masked utterance CMVN of (B, T, n_mel) f32 -> bf16, rows >= length zero."""
    cfg = LogMelConfig(normalize_means=norm_means, normalize_vars=norm_vars)
    mask = torch.arange(lm.shape[1], device=lm.device)[None, :] < lengths[:, None]
    return torch.where(mask[..., None], utterance_cmvn(lm, mask, cfg), 0.0).to(BF16)


def cmvn(lm: torch.Tensor, lengths: torch.Tensor, norm_means: bool = True,
         norm_vars: bool = True) -> torch.Tensor:
    """``cmvn_plain``; CUDA tensors run ``csrc/mel.cu::cmvn_kernel``: any
    count of mel bins up to ``MEL_MAX_BINS``."""
    if not _build.on_cuda(lm, lengths):
        return cmvn_plain(lm, lengths, norm_means, norm_vars)
    B, T, n_mel = lm.shape
    if n_mel > MEL_MAX_BINS:
        raise ValueError(f"the CMVN kernel takes at most MEL_MAX_BINS = {MEL_MAX_BINS} mel bins, got {n_mel}")
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
    in JAX. The DFT runs in ``config.matmul_precision`` (``MEL_MODES``; any
    other value raises, as in JAX). The bases live on ``device``, folded once
    here: ``dft`` fp32 (L, 2*bins) for "highest", ``split_bases``' bf16 for
    the other two.
    """

    def __init__(self, config: LogMelConfig = LogMelConfig(), device=None):
        if config.norm_type not in ("utterance", "none"):
            raise NotImplementedError(
                f"norm_type={config.norm_type!r}: use ops.features.LogMelFrontEnd")
        self.config = config
        self.mode = _check_mode(config.matmul_precision)
        dft, mel = folded_bases(config)
        self.dft = torch.as_tensor(dft, device=device) if self.mode == "highest" else \
            split_bases(dft, self.mode).to(device)
        self.mel = torch.as_tensor(mel, device=device)
        if self.mode != "highest" and self.mel.is_cuda:
            _kernel_table_of(self.mel)  # the bf16 kernel's table, made here and not in the first request

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
        lm = mel_fn(wav, n_frames, self.dft, self.mel, cfg.hop_length, cfg.mel_floor, self.mode)
        if cfg.norm_type == "none":
            mask = torch.arange(n_frames, device=dev)[None, :] < feat_lengths[:, None]
            return torch.where(mask[..., None], lm, 0.0), feat_lengths
        return cmvn_fn(lm, feat_lengths, cfg.normalize_means, cfg.normalize_vars), feat_lengths
