"""Conv subsampler, mel -> encoder hidden states: weight folds, plain version
and CUDA kernels (counterpart of ``huggingface_asr_tpu/ops/pallas_subsample.py``).

  conv1 (1->C, 3x3, s2, p1) + GELU      csrc/subsample.cu::conv1_kernel
  conv2 (C->C, 3x3, s2, p1) + GELU      csrc/conv2.cu, implicit GEMM on wgmma
  flatten + Dense (F2*C -> D)           gemm (rows of the Dense weight
                                        regathered into f2-major order)
  LayerNorm + Dense projection          ln_gemm (the LayerNorm in the GEMM's
                                        operand prologue)

Rounding points are the TPU kernel's: each product accumulates in fp32 and
rounds to bf16 BEFORE the bf16 bias is added (``round_first``), then the GELU
of the bf16 value rounds once. The GELU is the numeric profile's
(``layer.PROFILES``): ``"exact"``'s erfc form, or ``"serving"``'s A&S 7.1.27
form (``pallas_subsample.py:65-68`` reads the JAX profile's GELU too).
Output rows at or past the unpadded conv output length are computed from
zero inputs; callers mask them.
"""

from __future__ import annotations

import types
from typing import Dict

import torch
import torch.nn.functional as F

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels.layer import (
    BF16, F32, _round, act_plain, check_profile, gemm, gemm_plain, ln_gemm, ln_gemm_plain, profile_act,
)


def fits_subsample_kernel(cfg) -> bool:
    return (
        tuple(cfg.conv_dim) == (256, 256)
        and tuple(cfg.conv_kernel) == (3, 3)
        and tuple(cfg.conv_stride) == (2, 2)
        and tuple(cfg.conv_padding) == (1, 1)
        and cfg.feat_extract_activation == "gelu"
        and cfg.context_awareness_type in (None, "none")
        and not cfg.is_causal
        and cfg.num_fbanks == 80
    )


def _sizes(T_in: int, F_: int):
    """(T1, F1, F2): conv1 output frames and both layers' frequency bins."""
    return (T_in - 1) // 2 + 1, F_ // 2, F_ // 4


@torch.no_grad()
def fold_subsample_weights(wav2vec2, cfg, device=None) -> Dict[str, torch.Tensor]:
    """Kernel operands from ``EBranchformerModel``'s front end:
    w1 (9, C) and w2 (9*C, C) as (kt, kf)-major taps, wout (F2*C, D) with
    row f2*C + c holding the reference's channel-major row c*F2 + f2, wproj
    (D, D); matrices bf16, biases rounded to bf16 and kept fp32, LN fp32."""
    fe, fp = wav2vec2.feature_extractor, wav2vec2.feature_projection
    C = cfg.conv_dim[0]
    F2 = cfg.num_fbanks // 4
    c1, c2 = fe.conv[0][0].conv, fe.conv[1][0].conv
    D = fe.out.weight.shape[0]
    f32 = lambda t: t.detach().to(F32)
    w = {
        "w1": f32(c1.weight)[:, 0].permute(1, 2, 0).reshape(9, C).to(BF16),
        "b1": _round(f32(c1.bias)),
        "w2": f32(c2.weight).permute(2, 3, 1, 0).reshape(9 * C, C).to(BF16),
        "b2": _round(f32(c2.bias)),
        "wout": f32(fe.out.weight).t().reshape(C, F2, D).permute(1, 0, 2).reshape(F2 * C, D).to(BF16),
        "bout": _round(f32(fe.out.bias)),
        "ln_g": f32(fp.layer_norm.weight),
        "ln_b": f32(fp.layer_norm.bias),
        "wproj": f32(fp.projection.weight).t().to(BF16),
        "bproj": _round(f32(fp.projection.bias)),
    }
    return {k: v.contiguous().to(device) for k, v in w.items()}


def conv1_plain(feats: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, profile: str = "exact") -> torch.Tensor:
    """feats (B, T_in, F) bf16 -> (B, T1, F1, C) bf16:
    GELU(bf16(bf16(conv1(feats)) + b1)), rounded once; the profile's GELU."""
    C = w1.shape[1]
    wc = w1.to(F32).t().reshape(C, 1, 3, 3)
    y = F.conv2d(feats.to(F32)[:, None], wc, stride=2, padding=1)
    y = _round(_round(y) + b1[None, :, None, None])
    return act_plain(profile_act("gelu", profile), y).to(BF16).permute(0, 2, 3, 1).contiguous()


def conv1(feats: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, profile: str = "exact") -> torch.Tensor:
    """``conv1_plain``; CUDA tensors run ``csrc/subsample.cu::conv1_kernel``
    (under ``"serving"`` with the serving GELU's table, counted as
    ``asr_conv1_serving``)."""
    serving = check_profile(profile) == "serving"
    if not _build.on_cuda(feats, w1, b1):
        return conv1_plain(feats, w1, b1, profile)
    B, T_in, F_ = feats.shape
    C = w1.shape[1]
    T1, F1, _ = _sizes(T_in, F_)
    _build.check(feats, "feats", BF16)
    _build.check(w1, "w1", BF16, (9, C))
    _build.check(b1, "b1", F32, (C,))
    y1 = torch.empty(B, T1, F1, C, dtype=BF16, device=feats.device)
    _build.launch("asr_conv1", "ppppiiiiii", feats.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                  y1.data_ptr(), B, T_in, T1, F_, C, int(serving),
                  label="asr_conv1_serving" if serving else None)
    return y1


def conv2_plain(y1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, T2: int,
                profile: str = "exact") -> torch.Tensor:
    """y1 (B, T1, F1, C) bf16 -> (B*T2*F2, C) bf16, ``T2`` output frames
    (frames past conv1's output read zeros); the profile's GELU."""
    B, T1, F1, C = y1.shape
    x = y1.to(F32).permute(0, 3, 1, 2)
    T1_ext = max(T1, 2 * T2 - 1)
    x = F.pad(x, (0, 0, 0, T1_ext - T1))
    wc = w2.to(F32).reshape(3, 3, C, C).permute(3, 2, 0, 1)
    y = F.conv2d(x, wc, stride=2, padding=1)[:, :, :T2]
    y = act_plain(profile_act("gelu", profile), _round(_round(y) + b2[None, :, None, None])).to(BF16)
    return y.permute(0, 2, 3, 1).reshape(-1, C)


def conv2(y1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, T2: int, profile: str = "exact") -> torch.Tensor:
    """``conv2_plain``; CUDA tensors run the implicit-GEMM kernel ``csrc/conv2.cu``
    (C == 256: one block holds all output channels of up to 128 / F2 output
    frames; under ``"serving"`` counted as ``asr_conv2_serving``)."""
    serving = check_profile(profile) == "serving"
    if not _build.on_cuda(y1, w2, b2):
        return conv2_plain(y1, w2, b2, T2, profile)
    B, T1, F1, C = y1.shape
    F2 = F1 // 2
    if C != 256 or F1 % 2 or F2 > 128 or T1 < 2:
        raise ValueError(f"conv2 kernel needs C == 256, an even F1 <= 256 and T1 >= 2, got C={C}, F1={F1}, T1={T1}")
    _build.check(y1, "y1", BF16)
    _build.check(w2, "w2", BF16, (9 * C, C))
    _build.check(b2, "b2", F32, (C,))
    y2 = torch.empty(B * T2 * F2, C, dtype=BF16, device=y1.device)
    _build.launch("asr_conv2", "ppppiiiiiii", y1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  y2.data_ptr(), B, T1, F1, C, T2, F2, int(serving),
                  label="asr_conv2_serving" if serving else None)
    return y2


PLAIN_OPS = types.SimpleNamespace(conv1=conv1_plain, conv2=conv2_plain, gemm=gemm_plain, ln_gemm=ln_gemm_plain)
KERNEL_OPS = types.SimpleNamespace(conv1=conv1, conv2=conv2, gemm=gemm, ln_gemm=ln_gemm)


def _subsample(feats, w, cfg, T2_pad, ops, profile):
    if not fits_subsample_kernel(cfg):
        raise ValueError("config outside the fused subsampler's support")
    if T2_pad % 8:
        raise ValueError(f"T2_pad={T2_pad} must be a multiple of 8")
    feats = feats.to(BF16).contiguous()
    B, T_in, F_ = feats.shape
    C, D = cfg.conv_dim[-1], cfg.hidden_size
    F2 = F_ // 4
    y1 = ops.conv1(feats, w["w1"], w["b1"], profile)
    y2 = ops.conv2(y1, w["w2"], w["b2"], T2_pad, profile)
    h = ops.gemm(y2.view(B * T2_pad, F2 * C), w["wout"], w["bout"], round_first=True)
    h = ops.ln_gemm(h, w["ln_g"], w["ln_b"], cfg.layer_norm_eps, w["wproj"], w["bproj"], round_first=True)
    return h.view(B, T2_pad, D)


def conv_subsample_plain(feats, w, cfg, T2_pad: int, profile: str = "exact") -> torch.Tensor:
    """(B, T_in, 80) features -> (B, T2_pad, D) bf16 in plain PyTorch."""
    return _subsample(feats, w, cfg, T2_pad, PLAIN_OPS, check_profile(profile))


def conv_subsample(feats, w, cfg, T2_pad: int, profile: str = "exact") -> torch.Tensor:
    """``conv_subsample_plain`` on CPU tensors; each piece runs its kernel on CUDA."""
    return _subsample(feats, w, cfg, T2_pad, KERNEL_OPS, check_profile(profile))
