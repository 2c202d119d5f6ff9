"""Whisper encoder-decoder (seq2seq) in plain PyTorch (counterpart of
``huggingface_asr_tpu/models/whisper_seq2seq.py``; the reference fine-tunes
HF ``WhisperForConditionalGeneration`` as its AED model,
src/trainers/train_enc_dec_asr.py:82-85).

The audio encoder is ``models/whisper_ctc.py``'s (conv front end,
sinusoidal positions, pre-LN layers, final LayerNorm); the decoder adds
learned positions, causal self-attention with a fixed-size KV cache,
cross-attention whose K/V are computed once from the unexpanded encoder
state and shared by the beams, and an LM head tied to the token embedding.
Masks use -1e9, as the JAX model does.

Module names are HF ``WhisperForConditionalGeneration``'s
(``model.encoder.layers.{i}.self_attn.q_proj.weight``,
``model.decoder.embed_positions.weight``, ...), so an HF state dict loads
with ``load_state_dict(strict=True)`` once its tied ``proj_out.weight`` is
dropped (``interop/hf_whisper.py``).

The model computes in its ``dtype``: input features are cast to it and each
parameter is cast at its use; LayerNorm statistics and the softmax are fp32,
and the logits are the fp32 product of the final state with the fp32
embedding, as in JAX.

Incremental decoding keeps its state in an explicit cache (a flat dict of
tensors, ``init_cache`` then ``write_cross_kv``): per layer a
``max_length``-row self-attention K/V buffer with a write index on the
device, and the cross-attention K/V (``cached_enc_*``, which the beam
search's reorder leaves alone).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng, _drop, _ln
from huggingface_asr_tpu_torch.models.whisper_ctc import (
    WhisperEncoder,
    attend,
    dense,
    init_whisper_from_scratch_,
)
from huggingface_asr_tpu_torch.ops.lengths import lengths_to_mask
from huggingface_asr_tpu_torch.parallel.mesh import global_sum

NEG_INF = -1.0e9

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class WhisperSeq2SeqConfig:
    """Every field and default is the JAX package's."""

    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    decoder_ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    vocab_size: int = 51865
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    label_smoothing: float = 0.0
    # token ids (HF Whisper defaults)
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257
    pad_token_id: int = 50257

    @property
    def head_dim(self) -> int:
        return self.d_model // self.decoder_attention_heads

    @classmethod
    def from_hf_config(cls, hf) -> "WhisperSeq2SeqConfig":
        """From an HF ``WhisperConfig`` or its dict (``config.json``): the
        fields this config has, where they are not None."""
        d = hf if isinstance(hf, dict) else hf.to_dict()
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names and v is not None})

    @classmethod
    def from_dict(cls, d) -> "WhisperSeq2SeqConfig":
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


@dataclasses.dataclass
class WhisperSeq2SeqOutput:
    logits: Optional[torch.Tensor]
    loss: Optional[torch.Tensor] = None
    encoder_hidden: Optional[torch.Tensor] = None
    encoder_lengths: Optional[torch.Tensor] = None


class DecoderAttention(nn.Module):
    """Whisper-projection attention: causal self-attention (whole sequence or
    cached steps) or cross-attention (K/V from the encoder state, or from the
    cache ``write`` filled)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def kv(self, source: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, D = source.shape
        H = self.num_heads
        k, v = dense(self.k_proj, source), dense(self.v_proj, source)
        return k.reshape(B, S, H, D // H), v.reshape(B, S, H, D // H)

    def write(self, cache: Cache, prefix: str, encoder_hidden: torch.Tensor) -> None:
        cache[prefix + "cached_enc_key"], cache[prefix + "cached_enc_value"] = self.kv(encoder_hidden)

    def forward(self, x, kv_source=None, attention_bias=None, cache: Optional[Cache] = None, prefix: str = "",
                cross: bool = False):
        B, Tq, D = x.shape
        H = self.num_heads
        dh = D // H
        q = (dense(self.q_proj, x) * torch.tensor(dh ** -0.5, dtype=x.dtype)).reshape(B, Tq, H, dh)
        if cross:
            if cache is not None:
                k, v = cache[prefix + "cached_enc_key"], cache[prefix + "cached_enc_value"]
            else:
                k, v = self.kv(kv_source)
            # the W beams of a batch element fold into the query axis (no
            # causal mask here, so the fold is exact)
            W = B // k.shape[0]
            out = attend(q.reshape(k.shape[0], W * Tq, H, dh), k, v, attention_bias)
            return dense(self.out_proj, out.reshape(B, Tq, D))
        k, v = self.kv(x)
        if cache is not None:
            idx = cache[prefix + "cache_index"]
            k_buf, v_buf = cache[prefix + "cached_key"], cache[prefix + "cached_value"]
            rows = idx + torch.arange(Tq, device=x.device)
            k_buf.index_copy_(1, rows, k.to(k_buf.dtype))
            v_buf.index_copy_(1, rows, v.to(v_buf.dtype))
            idx.add_(Tq)
            k, v = k_buf, v_buf
            valid = torch.arange(k_buf.shape[1], device=x.device) < idx
            attention_bias = torch.where(valid, 0.0, NEG_INF)[None, None, None, :]
        out = attend(q, k, v, attention_bias)
        return dense(self.out_proj, out.reshape(B, Tq, D))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperSeq2SeqConfig):
        super().__init__()
        D, eps = cfg.d_model, cfg.layer_norm_eps
        self.dropout = cfg.dropout
        self.self_attn_layer_norm = nn.LayerNorm(D, eps=eps)
        self.self_attn = DecoderAttention(D, cfg.decoder_attention_heads)
        self.encoder_attn_layer_norm = nn.LayerNorm(D, eps=eps)
        self.encoder_attn = DecoderAttention(D, cfg.decoder_attention_heads)
        self.final_layer_norm = nn.LayerNorm(D, eps=eps)
        self.fc1 = nn.Linear(D, cfg.decoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, D)

    def forward(self, x, encoder_hidden=None, self_bias=None, cross_bias=None, cache: Optional[Cache] = None,
                prefix: str = "", rng: Optional[DropoutRng] = None):
        x = x + self.self_attn(_ln(self.self_attn_layer_norm, x), attention_bias=self_bias, cache=cache,
                               prefix=prefix + "self_attn.")
        x = x + self.encoder_attn(_ln(self.encoder_attn_layer_norm, x), encoder_hidden, cross_bias, cache,
                                  prefix + "encoder_attn.", cross=True)
        h = dense(self.fc2, torch.nn.functional.gelu(dense(self.fc1, _ln(self.final_layer_norm, x))))
        return x + _drop(rng, h, self.dropout)


class WhisperDecoder(nn.Module):
    """Token embedding, learned positions, the layers, the final LayerNorm
    and the tied LM head."""

    def __init__(self, cfg: WhisperSeq2SeqConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, cfg.d_model)
        self.layers = nn.ModuleList([DecoderLayer(cfg) for _ in range(cfg.decoder_layers)])
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)

    def init_cache(self, batch: int, max_length: int, dtype: torch.dtype, device=None) -> Cache:
        """Zeroed self-attention buffers of ``max_length`` positions for ``batch`` rows."""
        cfg = self.config
        shape = (batch, max_length, cfg.decoder_attention_heads, cfg.head_dim)
        cache: Cache = {}
        for i in range(cfg.decoder_layers):
            p = f"layers_{i}.self_attn."
            cache[p + "cached_key"] = torch.zeros(shape, dtype=dtype, device=device)
            cache[p + "cached_value"] = torch.zeros(shape, dtype=dtype, device=device)
            cache[p + "cache_index"] = torch.zeros((), dtype=torch.int64, device=device)
        return cache

    def write_cross_kv(self, cache: Cache, encoder_hidden: torch.Tensor) -> Cache:
        """Each layer's cross-attention K/V from the (B, S, D) encoder state, once."""
        for i, layer in enumerate(self.layers):
            layer.encoder_attn.write(cache, f"layers_{i}.encoder_attn.", encoder_hidden)
        return cache

    def forward(self, tokens: torch.Tensor, dtype: torch.dtype, encoder_hidden=None, encoder_lengths=None,
                position_offset: Optional[torch.Tensor] = None, cache: Optional[Cache] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """Logits (B, T, V) fp32. Without ``cache``: the whole sequence,
        causally masked, attending to ``encoder_hidden``. With ``cache``: T
        more tokens at ``position_offset`` (B,) (one step: T = 1), the
        cross-attention reading what ``write_cross_kv`` wrote, masked by
        ``encoder_lengths`` of the unexpanded batch."""
        B, T = tokens.shape
        x = self.embed_tokens.weight[tokens].to(dtype)
        table = self.embed_positions.weight
        if cache is not None and position_offset is not None:
            pos = table[position_offset.to(torch.int64)][:, None, :]
        else:
            pos = table[None, :T]
        x = (x + pos.to(dtype)).to(dtype)
        self_bias = None
        if cache is None:
            causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            self_bias = torch.where(causal, 0.0, NEG_INF)[None, None]
        cross_bias = None
        if encoder_lengths is not None:
            S = encoder_hidden.shape[1] if cache is None else cache["layers_0.encoder_attn.cached_enc_key"].shape[1]
            cross_bias = torch.where(lengths_to_mask(encoder_lengths, S), 0.0, NEG_INF)[:, None, None, :].float()
        enc = None if cache is not None else encoder_hidden.to(dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, enc, self_bias, cross_bias, cache, f"layers_{i}.", rng)
        x = _ln(self.layer_norm, x)
        return x.float() @ self.embed_tokens.weight.float().t()


class _Model(nn.Module):
    def __init__(self, cfg: WhisperSeq2SeqConfig):
        super().__init__()
        self.encoder = WhisperEncoder(cfg.num_mel_bins, cfg.d_model, cfg.encoder_layers, cfg.encoder_attention_heads,
                                      cfg.encoder_ffn_dim, cfg.max_source_positions, cfg.layer_norm_eps, cfg.dropout,
                                      neg_inf=NEG_INF)
        self.decoder = WhisperDecoder(cfg)


class WhisperForConditionalGeneration(nn.Module):
    """Whisper AED: encoder + tied-embedding decoder + the teacher-forced CE
    loss, computing in ``dtype``."""

    def __init__(self, config: WhisperSeq2SeqConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.model = _Model(config)

    def encode(self, input_features: torch.Tensor, input_lengths: Optional[torch.Tensor] = None,
               rng: Optional[DropoutRng] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(encoder state (B, S, D) in the model dtype, its lengths (B,))."""
        x, lengths, _ = self.model.encoder(input_features.to(self.dtype), input_lengths, rng)
        return x, lengths

    def init_cache(self, batch: int, max_length: int, device=None) -> Cache:
        return self.model.decoder.init_cache(batch, max_length, self.dtype, device)

    def write_cross_kv(self, cache: Cache, encoder_hidden: torch.Tensor) -> Cache:
        return self.model.decoder.write_cross_kv(cache, encoder_hidden.to(self.dtype))

    def decode_step(self, tokens: torch.Tensor, positions: torch.Tensor, cache: Cache,
                    encoder_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits (B, T, V) fp32 of ``tokens`` at ``positions`` (B,), the
        cache advanced by T."""
        return self.model.decoder(tokens, self.dtype, encoder_lengths=encoder_lengths, position_offset=positions,
                                  cache=cache)

    def forward(self, input_features: torch.Tensor, input_lengths: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, label_lengths: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> WhisperSeq2SeqOutput:
        """With ``labels`` (B, L) (gold ids, eos included): aligned teacher
        forcing, input ``[start] + labels[:, :-1]`` against ``labels`` under
        their length mask, with torch-style label smoothing. ``rng``: the
        training forward's dropout stream."""
        cfg = self.config
        enc, enc_lengths = self.encode(input_features, input_lengths, rng)
        loss = logits = None
        if labels is not None:
            B, L = labels.shape
            dec_in = torch.cat([torch.full_like(labels[:, :1], cfg.decoder_start_token_id), labels[:, :-1]], dim=1)
            logits = self.model.decoder(dec_in, self.dtype, enc, enc_lengths, rng=rng)
            mask = (lengths_to_mask(label_lengths, L) if label_lengths is not None
                    else torch.ones(B, L, dtype=torch.bool, device=labels.device)).float()
            logp = torch.log_softmax(logits, dim=-1)
            gold = logp.gather(-1, labels[..., None].long())[..., 0]
            if cfg.label_smoothing > 0.0:
                gold = (1 - cfg.label_smoothing) * gold + cfg.label_smoothing * logp.mean(dim=-1)
            loss = -(gold * mask).sum() / torch.clamp(global_sum(mask.sum()), min=1)
        return WhisperSeq2SeqOutput(logits=logits, loss=loss, encoder_hidden=enc, encoder_lengths=enc_lengths)


@torch.no_grad()
def init_seq2seq_from_scratch_(model: WhisperForConditionalGeneration,
                               generator: torch.Generator) -> WhisperForConditionalGeneration:
    """The Flax init's distributions (``init_whisper_from_scratch_``), the
    token and position embeddings ~ N(0, 0.02^2)."""
    return init_whisper_from_scratch_(model, generator, normal_002=(
        "model.decoder.embed_tokens.weight", "model.decoder.embed_positions.weight"))
