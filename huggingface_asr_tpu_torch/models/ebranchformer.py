"""E-Branchformer CTC model in plain PyTorch, inference and training forward
(counterpart of ``huggingface_asr_tpu/models/ebranchformer.py``).

Module attribute names follow the reference HF state-dict keys that
``huggingface_asr_tpu/interop/export_hf.py::export_ebranchformer_ctc`` emits,
so that export loads with ``load_state_dict(strict=True)``.

The model computes in the dtype of its input features: parameters (fp32 in a
trainer, or whatever ``model.to`` made them) are cast to it at each use, as
the Flax modules cast theirs to their ``dtype``; LayerNorm statistics, the
softmax and the CTC loss are fp32.

Training mode is a forward with ``rng`` given (a ``DropoutRng``): every
dropout site of the Flax model draws from it, and the attention core follows
``attention_impl`` as the Flax model's does:

- training, ``"pallas"`` (or ``"auto"`` on CUDA tensors):
  ``rel_attention_train`` (``kernels/train_attention.py``), whose in-kernel
  dropout takes the place of the probability dropout;
- inference, ``"pallas"``: ``rel_attention`` (``kernels/attention.py``), the
  shift form over the projected (2T-1) table;
- otherwise plain einsums over the factored scores.

On CPU tensors both wrappers run their plain versions; on CUDA tensors they
run their kernels or raise (a model the kernels do not take trains with
``attention_impl="xla"``). The inference path is
also the float32 reference that the fused path (``models/fast_infer.py``) is
held against. Supported: the plain 2-D conv front end and its gated
variants (``context_awareness_type`` "gated": each conv times the sigmoid of a
gate conv of the same shape; "gated_shared": the gate conv at
``shared_scale_factor`` times the kernel, stride and padding in time, one gate
frame for that many conv frames), self-attention with relative or rotary
positions (or none), causal models (``is_causal``: left padding of k - 1 in
both axes of the 2-D convs and in both depthwise convs, and a lower-triangular
attention mask), macaron FFs, cgMLP/CSGU (with or without its linear after
the conv) and the merge block, the SSL masking hook (BEST-RQ's noise,
``models/bestrq.py``, or wav2vec2's learned ``masked_spec_embed``,
``models/wav2vec2_ssl.py``) and the BEST-RQ fine-tuning adapters (layer
mixing, one additional layer). A causal or rotary model always takes the
plain attention, as the Flax model does: the kernels hold relative positions
without a causal mask.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from huggingface_asr_tpu_torch.kernels.attention import rel_attention
from huggingface_asr_tpu_torch.kernels.train_attention import rel_attention_train
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.ops.ctc import ctc_loss
from huggingface_asr_tpu_torch.ops.lengths import conv_output_length, lengths_to_mask
from huggingface_asr_tpu_torch.parallel.mesh import first_row, row_draw

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
    loss: Optional[torch.Tensor] = None
    # each layer's input, then the post-final-LayerNorm state (where asked for)
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None


def dropout_apply(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout given the keep draws: ``keep ? x / (1 - rate) : 0``."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class DropoutRng:
    """The explicit random stream of one training forward: a generator on the
    tensors' device for the elementwise masks and one on the host for the
    attention kernel's per-layer seeds (drawn without touching the device)."""

    def __init__(self, seed: int, device="cpu"):
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._host = torch.Generator().manual_seed(seed ^ 0x5DEECE66D)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate <= 0.0:
            return x
        u = row_draw(torch.rand, x.shape, generator=self.generator, device=x.device)
        return dropout_apply(x, u >= rate, rate)

    def seed(self) -> int:
        """An int32 for ``rel_attention_train``."""
        return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=self._host))


def _drop(rng: Optional[DropoutRng], x: torch.Tensor, rate: float) -> torch.Tensor:
    return x if rng is None else rng.dropout(x, rate)


def _lin(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``m(x)`` with the parameters cast to x's dtype."""
    return F.linear(x, m.weight.to(x.dtype), None if m.bias is None else m.bias.to(x.dtype))


def _ln(m: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32, result in x's dtype."""
    y = F.layer_norm(x.float(), m.normalized_shape, m.weight.float(), m.bias.float(), m.eps)
    return y.to(x.dtype)


def _dwconv(m: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Depthwise conv over time on (B, T, C); a causal conv (``left_pad``,
    see ``_depthwise_conv1d``) is padded on the left alone."""
    x = x.transpose(1, 2)
    if m.left_pad:
        x = F.pad(x, (m.left_pad, 0))
    y = F.conv1d(x, m.weight.to(x.dtype), m.bias.to(x.dtype), padding=m.padding, groups=m.groups)
    return y.transpose(1, 2)


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


def relative_positional_embeddings(T: int, D: int, device=None, dtype=torch.float32):
    """Transformer-XL table (2T-1, D): row i holds the sinusoid at relative
    position i - (T-1) (sin in the even columns, cos in the odd), built in float64."""
    pos = np.arange(-(T - 1), T, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, D, 2, dtype=np.float64) * -(np.log(10000.0) / D))
    table = np.zeros((2 * T - 1, D), dtype=np.float64)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return torch.as_tensor(table, dtype=dtype, device=device)


def rotary_cos_sin(T: int, head_size: int, base: int = 10000, device=None, dtype=torch.float32):
    """Rotary tables ``(cos, sin)``, each (T, head_size): angle ``t * base^(-2i/dh)``
    for the dh/2 frequencies, the two halves repeated, built in float64."""
    inv = 1.0 / (base ** (np.arange(0, head_size, 2, dtype=np.float64) / head_size))
    freqs = np.outer(np.arange(T, dtype=np.float64), inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.as_tensor(np.cos(emb), dtype=dtype, device=device),
            torch.as_tensor(np.sin(emb), dtype=dtype, device=device))


def relpos_tables(T: int, D: int, device=None, dtype=torch.float32):
    """Factored relative-position tables: ``(cos, sin)`` of angle ``t * w_i``
    for the D/2 sinusoid frequencies, each (T, D/2), built in float64."""
    half = np.exp(np.arange(0, D, 2, dtype=np.float64) * -(np.log(10000.0) / D))
    angles = np.arange(T, dtype=np.float64)[:, None] * half
    return (
        torch.as_tensor(np.cos(angles), dtype=dtype, device=device),
        torch.as_tensor(np.sin(angles), dtype=dtype, device=device),
    )


def _conv2d(conv: nn.Conv2d, x: torch.Tensor, pad) -> torch.Tensor:
    """``conv`` on (B, C, T, F) in x's dtype, after zero padding ``pad`` =
    ((time before, after), (frequency before, after))."""
    (t0, t1), (f0, f1) = pad
    x = F.pad(x, (f0, f1, t0, t1))
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=conv.stride)


class _GatedConv(nn.Module):
    """The gated front-end conv: ``conv(x) * sigmoid(gate(x))``. The reference
    names the two ``conv.conv`` and ``conv.gate``."""

    def __init__(self, c_in: int, c_out: int, k: int, s: int, gate_k, gate_s):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride=s)
        self.gate = nn.Conv2d(c_in, c_out, gate_k, stride=gate_s)


class _ConvLayer(nn.Module):
    """One front-end conv (``conv``, a Conv2d, or a ``_GatedConv``), applied
    by ``Conv2dFeatureExtractor``, which holds the padding."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


class Conv2dFeatureExtractor(nn.Module):
    """2-D convs over (B, T, F) mel input, channel-major flatten, Linear.

    ``context_awareness_type`` "gated" multiplies each conv by the sigmoid of
    a gate conv of the same shape; "gated_shared" runs the gate conv at
    ``shared_scale_factor`` (f) times the kernel, stride and padding in time,
    so that one gate frame multiplies f consecutive conv frames, and raises
    ``ValueError`` where the conv's frames are not f times the gate's (pad the
    input to a multiple of f post-conv frames). A causal model pads k - 1
    before each axis, time and frequency, and nothing after (the gate conv
    of "gated_shared": f k - 1 before in time)."""

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.kind = cfg.context_awareness_type if cfg.context_awareness_type not in (None, "none") else None
        if self.kind not in (None, "gated", "gated_shared"):
            raise ValueError(f"unknown context_awareness_type {cfg.context_awareness_type!r}")
        self.act = ACT[cfg.feat_extract_activation]
        self.factor = cfg.shared_scale_factor
        f_sh = self.factor if self.kind == "gated_shared" else 1
        chans = (1,) + tuple(cfg.conv_dim)
        self.conv = nn.ModuleList()
        self.pads, self.gate_pads = [], []
        for i, (k, s, p) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride, cfg.conv_padding)):
            if self.kind is None:
                conv = nn.Conv2d(chans[i], chans[i + 1], k, stride=s)
            else:
                conv = _GatedConv(chans[i], chans[i + 1], k, s, (k * f_sh, k), (s * f_sh, s))
            self.conv.append(nn.Sequential(_ConvLayer(conv)))
            if cfg.is_causal:
                self.pads.append(((k - 1, 0), (k - 1, 0)))
                self.gate_pads.append(((k * f_sh - 1, 0), (k - 1, 0)))
            else:
                self.pads.append(((p, p), (p, p)))
                self.gate_pads.append(((p * f_sh, p * f_sh), (p, p)))
        f = cfg.num_fbanks
        for (_, (f0, f1)), k, s in zip(self.pads, cfg.conv_kernel, cfg.conv_stride):
            f = conv_output_length(f + f0 + f1, k, s, 0)
        self.out = nn.Linear(cfg.conv_dim[-1] * f, cfg.hidden_size)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features[:, None]  # (B, 1, T, F)
        for block, pad, gate_pad in zip(self.conv, self.pads, self.gate_pads):
            conv = block[0].conv
            if self.kind is None:
                x = _conv2d(conv, x, pad)
            else:
                c = _conv2d(conv.conv, x, pad)
                g = torch.sigmoid(_conv2d(conv.gate, x, gate_pad))
                if self.kind == "gated_shared":
                    f = self.factor
                    if c.shape[2] != g.shape[2] * f:
                        raise ValueError(f"gated_shared needs conv time {c.shape[2]} == gate time {g.shape[2]} x "
                                         f"{f}; pad inputs to a multiple of {f} post-conv frames")
                    g = g.repeat_interleave(f, dim=2)
                x = c * g
            x = self.act(x)
        B, C, T, Fq = x.shape
        x = x.permute(0, 2, 1, 3).reshape(B, T, C * Fq)  # channel-major: c*F' + f
        return _lin(self.out, x)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = cfg.feat_proj_dropout

    def forward(self, x, rng: Optional[DropoutRng] = None):
        """(projection, its LayerNorm input): the second is what wav2vec2's
        quantizer reads (``extract_features``)."""
        norm = _ln(self.layer_norm, x)
        return _drop(rng, _lin(self.projection, norm), self.dropout), norm


class EBranchformerSelfAttention(nn.Module):
    """Multi-head self-attention; relative positions in the exact factored
    form: ``bd[t, s] = rot_t(W_pos^T q_v[t]) . PE_std[s]``; rotary positions
    as the Flax model applies them, to the layer input ``x`` before
    ``linear_q`` and ``linear_k`` (each dh-wide piece of x rotated in the
    half-split form ``x * cos + [-x2, x1] * sin``), not to q and k; a causal
    model masks the keys after each query (before the key-padding bias)."""

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        if cfg.position_embeddings_type not in ("relative", "rotary", "none"):
            raise ValueError(f"unknown position_embeddings_type {cfg.position_embeddings_type!r}")
        D = cfg.hidden_size
        self.H, self.dh = cfg.num_attention_heads, cfg.head_size
        self.relative = cfg.position_embeddings_type == "relative"
        self.rotary = cfg.position_embeddings_type == "rotary"
        self.causal = cfg.is_causal
        self.impl, self.attention_dropout = cfg.attention_impl, cfg.attention_dropout
        self.linear_q = nn.Linear(D, D)
        self.linear_k = nn.Linear(D, D)
        self.linear_v = nn.Linear(D, D)
        self.linear_out = nn.Linear(D, D)
        if self.relative:
            self.linear_pos = nn.Linear(D, D, bias=False)
            self.pos_bias_u = nn.Parameter(torch.zeros(self.H, self.dh))
            self.pos_bias_v = nn.Parameter(torch.zeros(self.H, self.dh))

    def forward(self, x: torch.Tensor, attention_bias: Optional[torch.Tensor],
                lengths: Optional[torch.Tensor] = None, rng: Optional[DropoutRng] = None,
                pos_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``lengths``: (B,) int32 valid key counts for the kernels (the
        encoder's lengths). ``pos_emb``: the (2T-1, D) table, given when the
        shift-form inference kernel may run; for a rotary model the
        ``rotary_cos_sin`` tables (T, dh) in x's dtype."""
        B, T, D = x.shape
        H, dh = self.H, self.dh
        qk_in = x
        if self.rotary:
            cos, sin = pos_emb
            h = x.view(B, T, H, dh)
            rotated = torch.cat([-h[..., dh // 2:], h[..., : dh // 2]], dim=-1)
            qk_in = (h * cos[None, :, None, :] + rotated * sin[None, :, None, :]).reshape(B, T, D)
        q = _lin(self.linear_q, qk_in).view(B, T, H, dh)
        k = _lin(self.linear_k, qk_in).view(B, T, H, dh)
        v = _lin(self.linear_v, x).view(B, T, H, dh)
        # the kernels hold no causal mask: a causal model takes the plain attention
        kernels_ok = not self.causal and lengths is not None
        if self.relative:
            q_u = q + self.pos_bias_u.to(x.dtype)
            q_v = q + self.pos_bias_v.to(x.dtype)
            if self.impl == "pallas" and rng is None and kernels_ok and pos_emb is not None:
                pos = _lin(self.linear_pos, pos_emb).view(-1, H, dh)
                out = rel_attention(q_u, q_v, k, v, pos, lengths).reshape(B, T, D)
                return _lin(self.linear_out, out)
            wp = self.linear_pos.weight.to(x.dtype).t().reshape(D, H, dh)  # (Din, H, dh)
            qw = torch.einsum("bthd,Dhd->bthD", q_v, wp)
            cos_t, sin_t = relpos_tables(T, D, x.device, x.dtype)
            r_cos, r_sin = cos_t[None, :, None, :], sin_t[None, :, None, :]
            qe, qo = qw[..., 0::2], qw[..., 1::2]
            q_rot = torch.cat([r_sin * qo - r_cos * qe, r_sin * qe + r_cos * qo], dim=-1)
            k_std = torch.cat([sin_t, cos_t], dim=-1)  # (T, D)
            use_train_kernel = self.impl == "pallas" or (self.impl == "auto" and x.is_cuda)
            if use_train_kernel and rng is not None and kernels_ok:
                # the kernel's own dropout takes the place of the probability dropout
                out = rel_attention_train(q_u, q_rot, k, v, k_std, lengths, rng.seed(),
                                          self.attention_dropout, row0=first_row()).reshape(B, T, D)
                return _lin(self.linear_out, out)
            scores = (torch.einsum("bthd,bshd->bhts", q_u, k)
                      + torch.einsum("bthD,sD->bhts", q_rot, k_std)) / math.sqrt(dh)
        else:
            scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dh)
        scores = scores.float()
        if self.causal:
            causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            scores = torch.where(causal, scores, NEG_INF)
        if attention_bias is not None:
            scores = scores + attention_bias
        probs = _drop(rng, torch.softmax(scores, dim=-1).to(x.dtype), self.attention_dropout)
        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, D)
        return _lin(self.linear_out, out)


class FeedForward(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.act = ACT[cfg.hidden_act]
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.activation_dropout, self.hidden_dropout = cfg.activation_dropout, cfg.hidden_dropout

    def forward(self, x, rng: Optional[DropoutRng] = None):
        x = _drop(rng, self.act(_lin(self.intermediate_dense, x)), self.activation_dropout)
        return _drop(rng, _lin(self.output_dense, x), self.hidden_dropout)


def _depthwise_conv1d(C: int, k: int, causal: bool = False) -> nn.Conv1d:
    """A depthwise conv over time, padded (k-1)/2 on both sides, or (causal)
    k - 1 on the left alone (``left_pad``, which ``_dwconv`` applies)."""
    conv = nn.Conv1d(C, C, k, padding=0 if causal else (k - 1) // 2, groups=C)
    conv.left_pad = k - 1 if causal else 0
    return conv


class ConvolutionalSpatialGatingUnit(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        n = cfg.intermediate_size // 2
        self.act = ACT[cfg.csgu_activation]
        self.norm = nn.LayerNorm(n, eps=cfg.layer_norm_eps)
        self.conv = _depthwise_conv1d(n, cfg.csgu_kernel_size, cfg.is_causal)
        if cfg.csgu_use_linear_after_conv:
            self.linear = nn.Linear(n, n)
        self.dropout = cfg.csgu_conv_dropout

    def forward(self, x, rng: Optional[DropoutRng] = None):
        x_r, x_g = x.chunk(2, dim=-1)
        x_g = _dwconv(self.conv, _ln(self.norm, x_g))
        if hasattr(self, "linear"):
            x_g = _lin(self.linear, x_g)
        return _drop(rng, x_r * self.act(x_g), self.dropout)


class ConvolutionalGatingMLP(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        # channel_proj1 is always exact GELU, whatever hidden_act is.
        self.channel_proj1 = nn.Sequential(
            nn.Linear(cfg.hidden_size, cfg.intermediate_size), nn.GELU()
        )
        self.csgu = ConvolutionalSpatialGatingUnit(cfg)
        self.channel_proj2 = nn.Linear(cfg.intermediate_size // 2, cfg.hidden_size)

    def forward(self, x, rng: Optional[DropoutRng] = None):
        x = F.gelu(_lin(self.channel_proj1[0], x))
        return _lin(self.channel_proj2, self.csgu(x, rng))


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
        self.depthwise_conv_fusion = _depthwise_conv1d(2 * D, cfg.merge_conv_kernel, cfg.is_causal)
        self.merge_proj = nn.Linear(2 * D, D)
        self.final_layer_norm = nn.LayerNorm(D, eps=eps)
        # The reference drops the attention and the merged branch outputs at
        # the ATTENTION dropout rate; the Flax model copies that, and so does this.
        self.branch_dropout = cfg.attention_dropout

    def forward(self, x, attention_bias=None, lengths=None, rng: Optional[DropoutRng] = None,
                pos_emb=None):
        if self.use_macaron_ff:
            x = x + 0.5 * self.ff1[1](_ln(self.ff1[0], x), rng)
        residual = x
        g = self.self_attn(_ln(self.self_attn_layer_norm, x), attention_bias, lengths, rng, pos_emb)
        g = _drop(rng, g, self.branch_dropout)
        l = self.cgMLP(_ln(self.cgMLP_layer_norm, x), rng)
        merged = torch.cat([g, l], dim=-1)
        merged = merged + _dwconv(self.depthwise_conv_fusion, merged)
        x = residual + _drop(rng, _lin(self.merge_proj, merged), self.branch_dropout)
        if self.use_macaron_ff:
            x = x + 0.5 * self.ff2[1](_ln(self.ff2[0], x), rng)
        return _ln(self.final_layer_norm, x)


class EBranchformerEncoder(nn.Module):
    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [EBranchformerEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)]
        )
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.hidden_dropout = cfg.hidden_dropout
        self.shift_kernel = (cfg.attention_impl == "pallas" and cfg.position_embeddings_type == "relative"
                             and not cfg.is_causal)
        self.rotary = (cfg.head_size, cfg.rotary_embedding_base) if cfg.position_embeddings_type == "rotary" else None

    def forward(self, x, mask: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None, output_hidden_states: bool = False):
        """``lengths``: the (B,) int32 counts that ``mask`` was made from, for
        the attention kernels. The Flax encoder runs every layer (it never
        applies ``layerdrop``), and so does this. Returns the final state and,
        with ``output_hidden_states``, every layer's input followed by the
        final state (else None)."""
        x = torch.where(mask[..., None], x, 0.0)
        bias = torch.where(mask, 0.0, NEG_INF)[:, None, None, :].float()
        x = _drop(rng, x, self.hidden_dropout)
        pos_emb = None
        if self.shift_kernel and rng is None and lengths is not None:
            pos_emb = relative_positional_embeddings(x.shape[1], x.shape[2], x.device, x.dtype)
        elif self.rotary is not None:
            pos_emb = rotary_cos_sin(x.shape[1], *self.rotary, x.device, x.dtype)
        all_hidden = [] if output_hidden_states else None
        for layer in self.layers:
            if output_hidden_states:
                all_hidden.append(x)
            x = layer(x, bias, lengths, rng, pos_emb)
        x = _ln(self.layer_norm, x)
        if output_hidden_states:
            all_hidden.append(x)
            return x, tuple(all_hidden)
        return x, None


class EBranchformerModel(nn.Module):
    """``masked_spec_embed``: give the encoder wav2vec2's learned mask
    embedding (only ``Wav2Vec2ForPreTraining`` builds one, as only the Flax
    tree called with masks and no noise has that parameter)."""

    def __init__(self, cfg: EBranchformerConfig, masked_spec_embed: bool = False):
        super().__init__()
        self.config = cfg
        self.feature_extractor = Conv2dFeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        if masked_spec_embed:
            self.masked_spec_embed = nn.Parameter(torch.rand(cfg.hidden_size))
        self.encoder = EBranchformerEncoder(cfg)

    def forward(self, input_features, input_lengths, rng: Optional[DropoutRng] = None,
                output_hidden_states: bool = False, mask_time_indices: Optional[torch.Tensor] = None,
                mask_noise: Optional[torch.Tensor] = None):
        """``mask_time_indices`` (B, T_enc) bool: the SSL masking hook, which
        replaces the masked frames after the feature projection by
        ``mask_noise`` (B, T_enc, hidden), BEST-RQ's noise, or else by the
        learned ``masked_spec_embed`` cast to the compute dtype. Returns the
        final state, the CTC lengths, the hidden states (or None) and the
        feature projection's LayerNorm output (``extract_features``)."""
        cfg = self.config
        hidden, extract_features = self.feature_projection(self.feature_extractor(input_features), rng)
        if mask_time_indices is not None:
            if mask_noise is None:
                if not hasattr(self, "masked_spec_embed"):
                    raise ValueError("masking without mask_noise needs masked_spec_embed: build the encoder with "
                                     "masked_spec_embed=True (wav2vec2 pretraining)")
                mask_noise = self.masked_spec_embed
            hidden = torch.where(mask_time_indices[..., None], mask_noise.to(hidden.dtype), hidden)
        T = hidden.shape[1]
        # Encoder masking uses the true padded-conv frame count; the RETURNED
        # lengths use the reference's unpadded formula (see the two helpers).
        enc_lengths = torch.clamp(feat_extract_output_frames(cfg, input_lengths), 0, T)
        out_lengths = torch.clamp(feat_extract_output_lengths(cfg, input_lengths), 0, T)
        last, all_hidden = self.encoder(hidden, lengths_to_mask(enc_lengths, T), enc_lengths.to(torch.int32),
                                        rng, output_hidden_states)
        return last, out_lengths.to(torch.int32), all_hidden, extract_features


class EBranchformerForCTC(nn.Module):
    """Encoder + vocab head + separate blank projection (the LAST logit),
    with BEST-RQ's fine-tuning adapters where the config sets them:

    - ``finetune_with_layer_mixing``: the heads read the softmax of
      ``per_layer_weights`` over the L + 1 hidden states (stacked and mixed in
      fp32, then cast to the compute dtype), initialised to select the last;
    - ``finetune_with_additional_layer``: one more E-Branchformer layer on
      top. The Flax model calls it without ``lengths``, so it always takes
      the plain attention with the additive mask; so does this (no K4/K5).
    """

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.config = cfg
        self.wav2vec2 = EBranchformerModel(cfg)
        if cfg.finetune_with_layer_mixing:
            self.per_layer_weights = nn.Parameter(F.one_hot(torch.tensor(cfg.num_hidden_layers),
                                                            cfg.num_hidden_layers + 1).float())
        if cfg.finetune_with_additional_layer:
            self.additional_layer = EBranchformerEncoderLayer(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        self.blank_projection = nn.Linear(cfg.hidden_size, 1)

        self.final_dropout = cfg.final_dropout

    def forward(self, input_features: torch.Tensor, input_lengths: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, label_lengths: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None, output_hidden_states: bool = False):
        """``rng`` given: the training forward (dropout on). ``labels`` given:
        the fp32 CTC loss (blank last) is returned too. ``output_hidden_states``:
        the output's ``hidden_states`` holds every layer's input and, last,
        the post-final-LayerNorm state that a joint model's decoder attends to."""
        B, T_in, _ = input_features.shape
        if input_lengths is None:
            input_lengths = torch.full((B,), T_in, dtype=torch.int32, device=input_features.device)
        cfg = self.config
        hidden, lengths, all_hidden, _ = self.wav2vec2(input_features, input_lengths, rng,
                                                       output_hidden_states or cfg.finetune_with_layer_mixing)
        if cfg.finetune_with_layer_mixing:
            mix = torch.softmax(self.per_layer_weights.float(), dim=0)[:, None, None, None]
            hidden = torch.sum(torch.stack(all_hidden).float() * mix, dim=0).to(hidden.dtype)
        if cfg.finetune_with_additional_layer:
            # masked with the CTC lengths, as the Flax model does
            mask = lengths_to_mask(lengths, hidden.shape[1])
            bias = torch.where(mask, 0.0, NEG_INF)[:, None, None, :].float()
            pos_emb = None
            if cfg.position_embeddings_type == "rotary":
                pos_emb = rotary_cos_sin(hidden.shape[1], cfg.head_size, cfg.rotary_embedding_base,
                                         hidden.device, hidden.dtype)
            hidden = self.additional_layer(torch.where(mask[..., None], hidden, 0.0), bias, None, rng, pos_emb)
        hidden = _drop(rng, hidden, self.final_dropout)
        logits = torch.cat([_lin(self.lm_head, hidden), _lin(self.blank_projection, hidden)], dim=-1)
        loss = None
        if labels is not None:
            loss = ctc_loss(logits.float(), lengths, labels, label_lengths, blank_id=-1,
                            reduction=self.config.ctc_loss_reduction)
        return CTCOutput(logits=logits, logit_lengths=lengths, loss=loss,
                         hidden_states=all_hidden if output_hidden_states else None)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator,
                 matrix_std: Optional[float] = None) -> nn.Module:
    """Seeded random weights for smoke runs: matrices ~ N(0, 1/fan_in), or
    ~ N(0, matrix_std^2) where ``matrix_std`` is given (a from-scratch
    trainer's ``initializer_range``); LayerNorm scales ~ 1 + N(0, 0.1^2),
    every other vector ~ N(0, 0.1^2). Draws on the CPU from ``generator`` and
    copies into place."""
    ln_scales = {
        f"{name}.weight" for name, m in model.named_modules() if isinstance(m, nn.LayerNorm)
    }
    for name, p in model.named_parameters():
        z = torch.randn(p.shape, generator=generator, dtype=torch.float32)
        if p.ndim >= 2:
            z = z / math.sqrt(p[0].numel()) if matrix_std is None else matrix_std * z
        elif name in ln_scales:
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        p.copy_(z)
    return model


# Flax's lecun_normal: a standard normal truncated to [-2, 2], scaled so that
# the result has variance 1 / fan_in (this constant is the std of the
# truncated standard normal).
_TRUNC_STD = 0.87962566103423978
_PHI_M2, _PHI_P2 = 0.5 * math.erfc(2.0 / math.sqrt(2.0)), 0.5 * math.erfc(-2.0 / math.sqrt(2.0))


def _lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """Draws of ``jax.nn.initializers.lecun_normal()`` (inverse CDF of the
    truncated normal, as ``jax.random.truncated_normal`` draws it)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (_PHI_P2 - _PHI_M2) + _PHI_M2
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (z.clamp(-2.0, 2.0) * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).float()


@torch.no_grad()
def init_from_scratch_(model: "EBranchformerForCTC", generator: torch.Generator,
                       lecun_linears=()) -> "EBranchformerForCTC":
    """The distributions of the JAX package's ``EBranchformerForCTC.init``, for
    a model trained from scratch (``cli/train_ctc.py`` when nothing is loaded):

    - every Dense kernel ~ N(0, ``initializer_range``^2) (the Flax model's
      ``_winit``), but the feature projection's, which keeps Flax's default
      lecun_normal;
    - every convolution kernel (the 2-D front-end convs and a gated front
      end's gate convs, the CSGU and merge depthwise convs) lecun_normal over
      its fan-in (input channels per group x kernel taps), Flax's ``nn.Conv``
      default;
    - every bias 0, the attention's ``pos_bias_u`` / ``pos_bias_v`` 0, every
      LayerNorm scale 1 and bias 0;
    - ``per_layer_weights`` (layer mixing) one-hot on the last entry; the
      additional layer as the encoder's layers;
    - wav2vec2's ``masked_spec_embed`` and quantizer ``codevectors``
      uniform on [0, 1).

    The draws come from ``generator`` on the CPU, in ``named_parameters``
    order, and are copied into place; a parameter of another kind raises.
    ``lecun_linears``: further Dense layers that keep Flax's default (BEST-RQ's
    classifiers; wav2vec2's ``weight_proj``, ``project_hid``, ``project_q``).
    ``model`` is any module with a ``config`` and a ``wav2vec2`` encoder.

    Caveat (b) of ROADMAP.md follows from the zero conv biases: a frame that
    SpecAugment's time mask zeroed stays exactly zero through the front end,
    reaches the feature projection's LayerNorm as a constant row, and its
    gradient is scaled by rsqrt(eps). At the flagship width the trainer's
    guard then rejects the steps with such frames, in the JAX trainer and
    here alike. This initialiser keeps that behaviour, to match the JAX
    trainer; ``--no-apply_spec_augment`` (or a preprocessing plan that starts
    SpecAugment later) is the way round it.
    """
    std = model.config.initializer_range
    lecun_dense = {id(model.wav2vec2.feature_projection.projection)} | {id(m) for m in lecun_linears}
    for module in model.modules():
        own = dict(module.named_parameters(recurse=False))
        if not own:
            continue
        if isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.fill_(0.0)
            continue
        for name, p in own.items():
            if name == "bias" or name in ("pos_bias_u", "pos_bias_v"):
                p.zero_()
            elif name == "per_layer_weights":
                p.copy_(F.one_hot(torch.tensor(p.numel() - 1), p.numel()).float())
            elif name in ("masked_spec_embed", "codevectors"):
                p.copy_(torch.rand(p.shape, generator=generator, dtype=torch.float32))
            elif name == "weight" and isinstance(module, nn.Linear) and id(module) not in lecun_dense:
                p.copy_(std * torch.randn(p.shape, generator=generator, dtype=torch.float32))
            elif name == "weight" and isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                p.copy_(_lecun_normal(p.shape, p[0].numel(), generator))
            else:
                raise ValueError(f"init_from_scratch_: no Flax initialiser known for {type(module).__name__}.{name}")
    return model
