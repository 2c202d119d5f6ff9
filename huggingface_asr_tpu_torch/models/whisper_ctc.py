"""Whisper-encoder CTC model in plain PyTorch (counterpart of
``huggingface_asr_tpu/models/whisper_ctc.py``; reference:
recipes_v0.0.1/librispeech_whisper_ctc/whisper_ctc.py:120-251).

A Whisper audio encoder (two Conv1d layers with exact GELU, fixed sinusoidal
positions, pre-LN transformer layers, a final LayerNorm), a ``dim_matching``
projection to the LLM width, one more encoder layer at that width
(``additional_layer_1``), an optional 2x stride-2 conv subsampling and a CTC
head whose blank is ``blank_token_id`` (index 0 by default, not the last).
The ``learnable_blank_head`` variant is the reference's
``LearnableBlankLinear`` (whisper_llm.py:33-44): a frozen vocabulary kernel
(a buffer here, so no optimizer ever sees it) and a trainable blank column,
both applied in fp32.

State-dict keys are the reference checkpoint's, which
``huggingface_asr_tpu/interop/hf_whisper.py`` reads: the encoder under
``encoder.`` with HF ``WhisperEncoder`` names (``encoder.conv1.weight`` as
(out, in, k), ``encoder.layers.{i}.self_attn.q_proj``, ...,
``encoder.embed_positions.weight``, the sinusoid table HF stores), then
``dim_matching``, ``additional_layer_1``, ``subsample_conv{1,2}`` and
``lm_head`` (or ``lm_head_frozen_kernel`` (llm_dim, V) and ``blank_kernel``
(llm_dim, 1), the JAX tree's names and layouts).

The model computes in the dtype of its input features, casting each
parameter to it at its use, as the Flax modules cast their fp32 parameters.
The JAX rounding points are kept: a Dense is the product in that dtype, then
the bias; attention scores are formed in that dtype and cast to fp32, the
mask bias is added and the softmax runs in fp32, and the probabilities are
cast back before P.V; LayerNorm statistics are fp32.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from huggingface_asr_tpu_torch.models.ebranchformer import CTCOutput, DropoutRng, _drop, _lecun_normal, _ln
from huggingface_asr_tpu_torch.ops.ctc import ctc_loss
from huggingface_asr_tpu_torch.ops.lengths import lengths_to_mask

NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class WhisperCTCConfig:
    """Every field and default is the JAX package's."""

    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    max_source_positions: int = 1500
    activation_function: str = "gelu"
    dropout: float = 0.0
    final_dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    # CTC head / extension
    vocab_size: int = 5000
    blank_token_id: int = 0
    llm_dim: int = 512  # dim of the extra layer + head (LLM width)
    additional_head_count: int = 8  # attention heads of the extra layer
    sub_sample: bool = False
    ctc_loss_reduction: str = "mean"
    learnable_blank_head: bool = False  # LearnableBlankLinear variant

    @classmethod
    def from_dict(cls, d) -> "WhisperCTCConfig":
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal position table (sin half, then cos half), float64."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)


def dense(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A Flax Dense in x's dtype: the product, then the bias (two roundings
    in a low-precision dtype, as XLA takes them)."""
    y = x @ m.weight.to(x.dtype).t()
    return y if m.bias is None else y + m.bias.to(x.dtype)


def conv1d(m: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A Flax ``nn.Conv`` over time on (B, T, C), in x's dtype."""
    y = F.conv1d(x.transpose(1, 2), m.weight.to(x.dtype), None if m.bias is None else m.bias.to(x.dtype),
                 stride=m.stride, padding=m.padding)
    return y.transpose(1, 2)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax(q k^T + bias) v over (B, Tq, H, dh) queries and (B, Tk, H, dh)
    keys/values, the JAX order of roundings: scores in the model dtype, fp32
    from the bias on, probabilities cast back before P.V. ``bias`` broadcasts
    to (B, H, Tq, Tk)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class WhisperAttention(nn.Module):
    """Whisper self-attention: ``k_proj`` has no bias; q is scaled by
    dh^-0.5 after its projection."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, attention_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        dh = D // H
        q = dense(self.q_proj, x) * torch.tensor(dh ** -0.5, dtype=x.dtype)
        k, v = dense(self.k_proj, x), dense(self.v_proj, x)
        out = attend(*(t.reshape(B, T, H, dh) for t in (q, k, v)), attention_bias)
        return dense(self.out_proj, out.reshape(B, T, D))


class WhisperEncoderLayer(nn.Module):
    """Pre-LN block: x + attn(LN(x)), then x + fc2(gelu(fc1(LN(x)))) with the
    FFN output's dropout."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, eps: float, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn_layer_norm = nn.LayerNorm(d_model, eps=eps)
        self.self_attn = WhisperAttention(d_model, num_heads)
        self.final_layer_norm = nn.LayerNorm(d_model, eps=eps)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)

    def forward(self, x, attention_bias=None, rng: Optional[DropoutRng] = None):
        x = x + self.self_attn(_ln(self.self_attn_layer_norm, x), attention_bias)
        h = dense(self.fc2, F.gelu(dense(self.fc1, _ln(self.final_layer_norm, x))))
        return x + _drop(rng, h, self.dropout)


class SinusoidalPositions(nn.Module):
    """The fixed table HF keeps as ``embed_positions.weight`` (a buffer here:
    it loads with the checkpoint and no optimizer sees it)."""

    def __init__(self, length: int, channels: int):
        super().__init__()
        self.register_buffer("weight", torch.as_tensor(_sinusoids(length, channels), dtype=torch.float32))


class WhisperEncoder(nn.Module):
    """The Whisper audio encoder, HF ``WhisperEncoder``'s module names: the
    conv front end, the positions, the layers and the final LayerNorm.
    ``forward`` gives the (B, T, d_model) state and its lengths
    ``clip((mel_lengths - 1) // 2 + 1, 0, T)``; padded frames are masked out
    of the attention with ``neg_inf``."""

    def __init__(self, num_mel_bins: int, d_model: int, layers: int, heads: int, ffn_dim: int,
                 max_source_positions: int, eps: float, dropout: float = 0.0, neg_inf: float = NEG_INF):
        super().__init__()
        self.max_source_positions = max_source_positions
        self.neg_inf = neg_inf
        self.conv1 = nn.Conv1d(num_mel_bins, d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(d_model, d_model, 3, stride=2, padding=1)
        self.embed_positions = SinusoidalPositions(max_source_positions, d_model)
        self.layers = nn.ModuleList([WhisperEncoderLayer(d_model, heads, ffn_dim, eps, dropout)
                                     for _ in range(layers)])
        self.layer_norm = nn.LayerNorm(d_model, eps=eps)

    def forward(self, input_features: torch.Tensor, input_lengths: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None):
        """(state, lengths, the attention's additive bias)."""
        B, T_mel, _ = input_features.shape
        if input_lengths is None:
            input_lengths = torch.full((B,), T_mel, dtype=torch.int32, device=input_features.device)
        x = F.gelu(conv1d(self.conv2, F.gelu(conv1d(self.conv1, input_features))))
        T = x.shape[1]
        if T > self.max_source_positions:
            raise ValueError(f"encoder frames {T} > max_source_positions {self.max_source_positions}; shorten/pad "
                             f"inputs to at most {2 * self.max_source_positions} mel frames")
        x = x + self.embed_positions.weight[:T].to(x.dtype)
        lengths = torch.clamp((input_lengths - 1) // 2 + 1, 0, T).to(torch.int32)
        bias = torch.where(lengths_to_mask(lengths, T), 0.0, self.neg_inf)[:, None, None, :].float()
        for layer in self.layers:
            x = layer(x, bias, rng)
        return _ln(self.layer_norm, x), lengths, bias


def whisper_output_lengths(config: WhisperCTCConfig, input_lengths):
    """Mel frames -> output frames: conv2's stride 2, then the optional 2x stride-2."""
    lengths = (input_lengths - 1) // 2 + 1
    if config.sub_sample:
        for _ in range(2):
            lengths = (lengths + 1) // 2
    return lengths


class WhisperEncoderForCTC(nn.Module):
    def __init__(self, config: WhisperCTCConfig):
        super().__init__()
        cfg = self.config = config
        eps = cfg.layer_norm_eps
        self.encoder = WhisperEncoder(cfg.num_mel_bins, cfg.d_model, cfg.encoder_layers,
                                      cfg.encoder_attention_heads, cfg.encoder_ffn_dim, cfg.max_source_positions,
                                      eps, cfg.dropout)
        self.dim_matching = nn.Linear(cfg.d_model, cfg.llm_dim)
        self.additional_layer_1 = WhisperEncoderLayer(cfg.llm_dim, cfg.additional_head_count, 4 * cfg.llm_dim,
                                                      eps, cfg.dropout)
        if cfg.sub_sample:
            self.subsample_conv1 = nn.Conv1d(cfg.llm_dim, cfg.llm_dim, 3, stride=2, padding=1, bias=False)
            self.subsample_conv2 = nn.Conv1d(cfg.llm_dim, cfg.llm_dim, 3, stride=2, padding=1, bias=False)
        if cfg.learnable_blank_head:
            self.register_buffer("lm_head_frozen_kernel", torch.zeros(cfg.llm_dim, cfg.vocab_size))
            self.blank_kernel = nn.Parameter(torch.zeros(cfg.llm_dim, 1))
        else:
            self.lm_head = nn.Linear(cfg.llm_dim, cfg.vocab_size, bias=False)

    def forward(self, input_features: torch.Tensor, input_lengths: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, label_lengths: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> CTCOutput:
        """(B, T_mel, num_mel_bins) features in the compute dtype -> logits
        (B, T_out, V) (fp32 with ``learnable_blank_head``), their lengths, the
        CTC loss where ``labels`` are given, and ``hidden_states[-1]``, the
        pre-head state that LLM-ASR reads. ``rng``: the training forward's
        dropout stream."""
        cfg = self.config
        x, lengths, bias = self.encoder(input_features, input_lengths, rng)
        x = self.additional_layer_1(dense(self.dim_matching, x), bias, rng)
        x = _drop(rng, x, cfg.final_dropout)
        if cfg.sub_sample:
            for conv in (self.subsample_conv1, self.subsample_conv2):
                x = conv1d(conv, x)
                lengths = (lengths + 1) // 2
        if cfg.learnable_blank_head:
            xf = x.float()
            logits = xf @ self.lm_head_frozen_kernel.float()
            blank = (xf @ self.blank_kernel.float())[..., 0]
            one_hot = F.one_hot(torch.tensor(cfg.blank_token_id), cfg.vocab_size).to(logits)
            logits = logits * (1 - one_hot) + blank[..., None] * one_hot
        else:
            logits = x @ self.lm_head.weight.to(x.dtype).t()
        loss = None
        if labels is not None:
            loss = ctc_loss(logits.float(), lengths, labels, label_lengths, blank_id=cfg.blank_token_id,
                            reduction=cfg.ctc_loss_reduction)
        return CTCOutput(logits=logits, logit_lengths=lengths, loss=loss, hidden_states=(x,))


@torch.no_grad()
def init_whisper_from_scratch_(model: nn.Module, generator: torch.Generator, normal_002: Sequence[str] = (),
                               skip: Sequence[str] = ()) -> nn.Module:
    """The distributions of the Flax defaults the JAX Whisper modules use:
    every Dense and Conv kernel (and ``lm_head_frozen_kernel``,
    ``blank_kernel``) lecun_normal over its fan-in, every bias 0, LayerNorm
    scales 1 and biases 0; the parameters named in ``normal_002`` ~ N(0,
    0.02^2) (embeddings, soft prompts); those whose name starts with an entry
    of ``skip`` are left as they are (a GPT-2 decoder, drawn by its own
    initialiser). The draws come from ``generator`` on the CPU, in
    ``named_parameters`` order (then the frozen kernel), and are copied into
    place; the sinusoid tables are not touched."""
    ln = {f"{n}.{p}" for n, m in model.named_modules() if isinstance(m, nn.LayerNorm) for p in ("weight", "bias")}
    for name, p in model.named_parameters():
        if any(name.startswith(s) for s in skip):
            continue
        if name in ln:
            p.fill_(1.0 if name.endswith(".weight") else 0.0)
        elif name in normal_002:
            p.copy_(0.02 * torch.randn(p.shape, generator=generator, dtype=torch.float32))
        elif name.endswith(".bias"):
            p.zero_()
        elif name.endswith("blank_kernel"):
            p.copy_(_lecun_normal(p.shape, p.shape[0], generator))
        elif p.ndim >= 2:
            p.copy_(_lecun_normal(p.shape, p[0].numel(), generator))
        else:
            raise ValueError(f"init_whisper_from_scratch_: no Flax initialiser known for {name}")
    for name, b in model.named_buffers():
        if name.endswith("lm_head_frozen_kernel"):
            b.copy_(_lecun_normal(b.shape, b.shape[0], generator))
    return model
