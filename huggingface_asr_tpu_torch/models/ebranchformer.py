"""E-Branchformer CTC model, inference forward in plain PyTorch
(counterpart of ``huggingface_asr_tpu/models/ebranchformer.py``).

Module attribute names follow the reference HF state-dict keys that
``huggingface_asr_tpu/interop/export_hf.py::export_ebranchformer_ctc`` emits,
so that export loads with ``load_state_dict(strict=True)``.

This is the CPU path and the float32 reference that the CUDA kernels of the
fused path (``models/fast_infer.py``) are held against. Supported: the plain
2-D conv front end, non-causal self-attention with relative positions in the
factored form (or no positions), macaron FFs, cgMLP/CSGU and the merge
block. The gated conv front ends, causal models, rotary positions and the
BEST-RQ fine-tuning adapters raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.ops.lengths import conv_output_length, lengths_to_mask

ACT = {
    "gelu": lambda x: F.gelu(x),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "swish": F.silu,
    "silu": F.silu,
    "identity": lambda x: x,
}

# Additive mask value: finite, so a fully masked row softmaxes to uniform
# instead of NaN (the JAX package's NEG_INF).
NEG_INF = -1.0e9


@dataclasses.dataclass
class CTCOutput:
    logits: torch.Tensor
    logit_lengths: torch.Tensor


def feat_extract_output_frames(config: EBranchformerConfig, input_lengths):
    """Tensor frame count after the 2-D conv stack (the true padded-conv
    arithmetic). Used for sizing and for the encoder's mask."""
    lengths = input_lengths
    for k, s, p in zip(config.conv_kernel, config.conv_stride, config.conv_padding):
        pad = (k - 1) if config.is_causal else 2 * p
        lengths = conv_output_length(lengths + pad, k, s, padding=0)
    return lengths


def feat_extract_output_lengths(config: EBranchformerConfig, input_lengths):
    """Valid frame count after the conv stack in the reference's convention:
    ``(L - kernel) // stride + 1`` per layer with no padding term, although the
    convs are padded. These are the lengths the CTC decode uses."""
    lengths = input_lengths
    for k, s in zip(config.conv_kernel, config.conv_stride):
        lengths = conv_output_length(lengths, k, s, padding=0)
    if isinstance(lengths, torch.Tensor):
        return torch.clamp(lengths, min=0)
    if isinstance(lengths, np.ndarray):
        return np.maximum(lengths, 0)
    return max(int(lengths), 0)


def relpos_tables(T: int, D: int, device=None, dtype=torch.float32):
    """Factored relative-position tables: ``(cos, sin)`` of angle ``t * w_i``
    for the D/2 sinusoid frequencies, each (T, D/2), built in float64."""
    half = np.exp(np.arange(0, D, 2, dtype=np.float64) * -(np.log(10000.0) / D))
    angles = np.arange(T, dtype=np.float64)[:, None] * half
    return (
        torch.as_tensor(np.cos(angles), dtype=dtype, device=device),
        torch.as_tensor(np.sin(angles), dtype=dtype, device=device),
    )


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, s: int, p: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride=s, padding=p)

    def forward(self, x):
        return self.conv(x)


class Conv2dFeatureExtractor(nn.Module):
    """2-D convs over (B, T, F) mel input, channel-major flatten, Linear."""

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        if cfg.context_awareness_type not in (None, "none"):
            raise NotImplementedError(
                f"context_awareness_type={cfg.context_awareness_type!r} is not ported yet"
            )
        self.act = ACT[cfg.feat_extract_activation]
        chans = (1,) + tuple(cfg.conv_dim)
        self.conv = nn.ModuleList([
            nn.Sequential(_ConvLayer(chans[i], chans[i + 1], k, s, p))
            for i, (k, s, p) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride, cfg.conv_padding))
        ])
        f = cfg.num_fbanks
        for k, s, p in zip(cfg.conv_kernel, cfg.conv_stride, cfg.conv_padding):
            f = conv_output_length(f, k, s, p)
        self.out = nn.Linear(cfg.conv_dim[-1] * f, cfg.hidden_size)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features[:, None]  # (B, 1, T, F)
        for block in self.conv:
            x = self.act(block(x))
        B, C, T, Fq = x.shape
        x = x.permute(0, 2, 1, 3).reshape(B, T, C * Fq)  # channel-major: c*F' + f
        return self.out(x)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class EBranchformerSelfAttention(nn.Module):
    """Multi-head self-attention; relative positions in the exact factored
    form: ``bd[t, s] = rot_t(W_pos^T q_v[t]) . PE_std[s]``."""

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        if cfg.position_embeddings_type not in ("relative", "none"):
            raise NotImplementedError(
                f"position_embeddings_type={cfg.position_embeddings_type!r} is not ported yet"
            )
        D = cfg.hidden_size
        self.H, self.dh = cfg.num_attention_heads, cfg.head_size
        self.relative = cfg.position_embeddings_type == "relative"
        self.linear_q = nn.Linear(D, D)
        self.linear_k = nn.Linear(D, D)
        self.linear_v = nn.Linear(D, D)
        self.linear_out = nn.Linear(D, D)
        if self.relative:
            self.linear_pos = nn.Linear(D, D, bias=False)
            self.pos_bias_u = nn.Parameter(torch.zeros(self.H, self.dh))
            self.pos_bias_v = nn.Parameter(torch.zeros(self.H, self.dh))

    def forward(self, x: torch.Tensor, attention_bias: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, D = x.shape
        H, dh = self.H, self.dh
        q = self.linear_q(x).view(B, T, H, dh)
        k = self.linear_k(x).view(B, T, H, dh)
        v = self.linear_v(x).view(B, T, H, dh)
        if self.relative:
            q_u = q + self.pos_bias_u
            q_v = q + self.pos_bias_v
            wp = self.linear_pos.weight.t().reshape(D, H, dh)  # (Din, H, dh)
            qw = torch.einsum("bthd,Dhd->bthD", q_v, wp)
            cos_t, sin_t = relpos_tables(T, D, x.device, x.dtype)
            r_cos, r_sin = cos_t[None, :, None, :], sin_t[None, :, None, :]
            qe, qo = qw[..., 0::2], qw[..., 1::2]
            q_rot = torch.cat([r_sin * qo - r_cos * qe, r_sin * qe + r_cos * qo], dim=-1)
            k_std = torch.cat([sin_t, cos_t], dim=-1)  # (T, D)
            scores = (torch.einsum("bthd,bshd->bhts", q_u, k)
                      + torch.einsum("bthD,sD->bhts", q_rot, k_std)) / math.sqrt(dh)
        else:
            scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dh)
        scores = scores.float()
        if attention_bias is not None:
            scores = scores + attention_bias
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, D)
        return self.linear_out(out)


class FeedForward(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.act = ACT[cfg.hidden_act]
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(self.act(self.intermediate_dense(x)))


def _depthwise_conv1d(C: int, k: int) -> nn.Conv1d:
    return nn.Conv1d(C, C, k, padding=(k - 1) // 2, groups=C)


class ConvolutionalSpatialGatingUnit(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        n = cfg.intermediate_size // 2
        self.act = ACT[cfg.csgu_activation]
        self.norm = nn.LayerNorm(n, eps=cfg.layer_norm_eps)
        self.conv = _depthwise_conv1d(n, cfg.csgu_kernel_size)
        if cfg.csgu_use_linear_after_conv:
            self.linear = nn.Linear(n, n)

    def forward(self, x):
        x_r, x_g = x.chunk(2, dim=-1)
        x_g = self.norm(x_g)
        x_g = self.conv(x_g.transpose(1, 2)).transpose(1, 2)
        if hasattr(self, "linear"):
            x_g = self.linear(x_g)
        return x_r * self.act(x_g)


class ConvolutionalGatingMLP(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        # channel_proj1 is always exact GELU, whatever hidden_act is.
        self.channel_proj1 = nn.Sequential(
            nn.Linear(cfg.hidden_size, cfg.intermediate_size), nn.GELU()
        )
        self.csgu = ConvolutionalSpatialGatingUnit(cfg)
        self.channel_proj2 = nn.Linear(cfg.intermediate_size // 2, cfg.hidden_size)

    def forward(self, x):
        return self.channel_proj2(self.csgu(self.channel_proj1(x)))


class EBranchformerEncoderLayer(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.use_macaron_ff = cfg.use_macaron_ff
        if cfg.use_macaron_ff:
            self.ff1 = nn.Sequential(nn.LayerNorm(D, eps=eps), FeedForward(cfg))
            self.ff2 = nn.Sequential(nn.LayerNorm(D, eps=eps), FeedForward(cfg))
        self.self_attn_layer_norm = nn.LayerNorm(D, eps=eps)
        self.self_attn = EBranchformerSelfAttention(cfg)
        self.cgMLP_layer_norm = nn.LayerNorm(D, eps=eps)
        self.cgMLP = ConvolutionalGatingMLP(cfg)
        self.depthwise_conv_fusion = _depthwise_conv1d(2 * D, cfg.merge_conv_kernel)
        self.merge_proj = nn.Linear(2 * D, D)
        self.final_layer_norm = nn.LayerNorm(D, eps=eps)

    def forward(self, x, attention_bias=None):
        if self.use_macaron_ff:
            x = x + 0.5 * self.ff1(x)
        residual = x
        g = self.self_attn(self.self_attn_layer_norm(x), attention_bias)
        l = self.cgMLP(self.cgMLP_layer_norm(x))
        merged = torch.cat([g, l], dim=-1)
        merged = merged + self.depthwise_conv_fusion(merged.transpose(1, 2)).transpose(1, 2)
        x = residual + self.merge_proj(merged)
        if self.use_macaron_ff:
            x = x + 0.5 * self.ff2(x)
        return self.final_layer_norm(x)


class EBranchformerEncoder(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [EBranchformerEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)]
        )
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, mask: torch.Tensor):
        x = torch.where(mask[..., None], x, 0.0)
        bias = torch.where(mask, 0.0, NEG_INF)[:, None, None, :].float()
        for layer in self.layers:
            x = layer(x, bias)
        return self.layer_norm(x)


class EBranchformerModel(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.config = cfg
        self.feature_extractor = Conv2dFeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = EBranchformerEncoder(cfg)

    def forward(self, input_features, input_lengths):
        cfg = self.config
        hidden = self.feature_projection(self.feature_extractor(input_features))
        T = hidden.shape[1]
        # Encoder masking uses the true padded-conv frame count; the RETURNED
        # lengths use the reference's unpadded formula (see the two helpers).
        enc_lengths = torch.clamp(feat_extract_output_frames(cfg, input_lengths), 0, T)
        out_lengths = torch.clamp(feat_extract_output_lengths(cfg, input_lengths), 0, T)
        last = self.encoder(hidden, lengths_to_mask(enc_lengths, T))
        return last, out_lengths.to(torch.int32)


class EBranchformerForCTC(nn.Module):
    """Encoder + vocab head + separate blank projection (the LAST logit)."""

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        if cfg.is_causal:
            raise NotImplementedError("causal E-Branchformer is not ported yet")
        if cfg.finetune_with_layer_mixing or cfg.finetune_with_additional_layer:
            raise NotImplementedError("BEST-RQ fine-tuning adapters are not ported yet")
        self.config = cfg
        self.wav2vec2 = EBranchformerModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        self.blank_projection = nn.Linear(cfg.hidden_size, 1)

    def forward(self, input_features: torch.Tensor, input_lengths: Optional[torch.Tensor] = None):
        B, T_in, _ = input_features.shape
        if input_lengths is None:
            input_lengths = torch.full((B,), T_in, dtype=torch.int32, device=input_features.device)
        hidden, lengths = self.wav2vec2(input_features, input_lengths)
        logits = torch.cat([self.lm_head(hidden), self.blank_projection(hidden)], dim=-1)
        return CTCOutput(logits=logits, logit_lengths=lengths)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for smoke runs: matrices ~ N(0, 1/fan_in),
    LayerNorm scales ~ 1 + N(0, 0.1^2), every other vector ~ N(0, 0.1^2).
    Draws on the CPU from ``generator`` and copies into place."""
    ln_scales = {
        f"{name}.weight" for name, m in model.named_modules() if isinstance(m, nn.LayerNorm)
    }
    for name, p in model.named_parameters():
        z = torch.randn(p.shape, generator=generator, dtype=torch.float32)
        if p.ndim >= 2:
            z = z / math.sqrt(p[0].numel())
        elif name in ln_scales:
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        p.copy_(z)
    return model
