"""GPT-2 decoder with cross-attention and intermediate LM heads, the DeCRED
decoder, for inference (counterpart of
``huggingface_asr_tpu/models/gpt2_decoder.py``).

Module attribute names follow the HF keys that
``huggingface_asr_tpu/interop/export_hf.py::export_gpt2_decoder`` writes
(``transformer.h.{i}.attn.c_attn``, ``lm_head``, ``additional_lm_heads.{k}``),
so a converted checkpoint loads with ``load_state_dict(strict=True)``. GPT-2
``Conv1D`` weights are stored (in, out); ``lm_head`` and the additional heads
are ``nn.Linear`` (out, in).

The decoder computes in its ``dtype``. The Flax modules keep fp32 parameters
and cast each at its use; here the weights of the products and the embedding
tables are held in ``dtype`` from construction on (``load_state_dict`` and
``init_random_`` round into them once, to the same values), so a decode step
casts none. LayerNorm parameters stay fp32; its statistics and the softmax
are fp32. Attention keeps the JAX order of roundings: scores in the model dtype
divided by ``sqrt(dh)`` cast to that dtype, fp32 from the mask bias on, the
probabilities cast back before P.V.

Incremental decoding keeps its state in an explicit cache (a flat dict of
tensors, ``init_cache``): per layer a fixed-size self-attention K/V buffer of
``max_length`` rows with a write index on the device, and the
cross-attention K/V written once from the unexpanded (B, S, D) encoder state
(``write_cross_kv``) and shared by the W beams of each batch element. Every
buffer keeps its shape for the whole search.

The training half (``smoothed_cross_entropy``, the loss with labels, the
mixing and residual heads) is not ported yet: the forward takes no labels,
and the two head options raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from huggingface_asr_tpu_torch.models.ebranchformer import _ln

NEG_INF = torch.finfo(torch.float32).min

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GPT2DecoderConfig:
    """Every field and default is the JAX package's."""

    vocab_size: int = 5000
    n_positions: int = 1024
    n_embd: int = 256
    n_layer: int = 6
    n_head: int = 4
    n_inner: Optional[int] = None  # defaults to 4*n_embd
    activation_function: str = "gelu_new"
    resid_pdrop: float = 0.1
    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    layer_norm_epsilon: float = 1e-5
    add_cross_attention: bool = True
    # DeCRED multi-head
    head_locations: Tuple[int, ...] = ()  # indices into the hidden-state tuple
    head_weights: Tuple[float, ...] = (1.0,)  # len == len(head_locations)+1
    tie_additional_weights: bool = False
    tie_word_embeddings: bool = False
    average_logits: bool = False
    lsm_factor: float = 0.0
    # fixed sinusoidal positions and sqrt(d)-scaled input embeddings
    pos_emb_fixed: bool = False
    bos_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: Optional[int] = None
    mixing_mode: Optional[str] = None
    connected_residuals: Tuple[int, ...] = ()

    @property
    def inner_dim(self):
        return self.n_inner or 4 * self.n_embd

    @property
    def head_dim(self):
        return self.n_embd // self.n_head

    @classmethod
    def from_dict(cls, d) -> "GPT2DecoderConfig":
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


ACT = {
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": F.gelu,
    "relu": F.relu,
}


def sinusoidal_positions(n_pos: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Transformer-XL style table: cat(sin, cos) over inv_freq, built in float64."""
    inv_freq = 1.0 / (10000 ** (np.arange(0.0, dim, 2.0) / dim))
    sinusoid = np.outer(np.arange(n_pos, dtype=np.float64), inv_freq)
    table = np.concatenate([np.sin(sinusoid), np.cos(sinusoid)], axis=-1)
    return torch.as_tensor(table, dtype=dtype, device=device)


class Conv1D(nn.Module):
    """GPT-2's dense layer: weight stored (in, out)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # product, then bias: the Flax Dense's two roundings in a low-precision dtype
        return x @ self.weight + self.bias


def _attend(q, k, v, dtype, bias):
    """softmax((q k^T) / sqrt(dh) + bias) v over (B, Tq, H, dh) queries and
    (B, Tk, H, dh) keys/values; ``bias`` broadcasts to (B, H, Tq, Tk) fp32."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(math.sqrt(dh), dtype=dtype)
    scores = scores.float()
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class SelfAttention(nn.Module):
    """Causal self-attention, whole sequence or one cached step."""

    def __init__(self, cfg: GPT2DecoderConfig):
        super().__init__()
        D = cfg.n_embd
        self.H, self.dh = cfg.n_head, cfg.head_dim
        self.c_attn = Conv1D(D, 3 * D)
        self.c_proj = Conv1D(D, D)

    def forward(self, x, cache: Optional[Cache] = None, prefix: str = ""):
        B, Tq, D = x.shape
        H, dh = self.H, self.dh
        q, k, v = self.c_attn(x).split(D, dim=-1)
        q, k, v = (t.reshape(B, Tq, H, dh) for t in (q, k, v))
        if cache is None:
            causal = torch.ones(Tq, Tq, dtype=torch.bool, device=x.device).tril()
            bias = torch.where(causal, 0.0, NEG_INF)[None, None]
        else:
            # fixed-size buffers and a write index on the device
            idx = cache[prefix + "cache_index"]
            k_buf, v_buf = cache[prefix + "cached_key"], cache[prefix + "cached_value"]
            rows = idx + torch.arange(Tq, device=x.device)
            k_buf.index_copy_(1, rows, k.to(k_buf.dtype))
            v_buf.index_copy_(1, rows, v.to(v_buf.dtype))
            idx.add_(Tq)
            k, v = k_buf, v_buf
            valid = torch.arange(k_buf.shape[1], device=x.device) < idx
            bias = torch.where(valid, 0.0, NEG_INF)[None, None, None, :]
        return self.c_proj(_attend(q, k, v, x.dtype, bias).reshape(B, Tq, D))


class CrossAttention(nn.Module):
    """Attention over the encoder state. With a cache, K/V are read from the
    buffers ``write`` filled from the unexpanded encoder state: the W beams of
    a batch element fold into the query-time axis, so each step reads the
    (B, S, H, dh) K/V once instead of W times (no causal mask, so the fold is
    exact)."""

    def __init__(self, cfg: GPT2DecoderConfig):
        super().__init__()
        D = cfg.n_embd
        self.H, self.dh = cfg.n_head, cfg.head_dim
        self.q_attn = Conv1D(D, D)
        self.c_attn = Conv1D(D, 2 * D)
        self.c_proj = Conv1D(D, D)

    def kv(self, encoder_hidden):
        B, S, D = encoder_hidden.shape
        k, v = self.c_attn(encoder_hidden).split(D, dim=-1)
        return k.reshape(B, S, self.H, self.dh), v.reshape(B, S, self.H, self.dh)

    def write(self, cache: Cache, prefix: str, encoder_hidden):
        k, v = self.kv(encoder_hidden)
        cache[prefix + "cached_enc_key"], cache[prefix + "cached_enc_value"] = k, v

    def forward(self, x, encoder_hidden=None, encoder_bias=None, cache: Optional[Cache] = None,
                prefix: str = ""):
        B, Tq, D = x.shape
        q = self.q_attn(x)
        if cache is not None:
            k, v = cache[prefix + "cached_enc_key"], cache[prefix + "cached_enc_value"]
        else:
            k, v = self.kv(encoder_hidden)
        W = B // k.shape[0]
        q = q.reshape(k.shape[0], W * Tq, self.H, self.dh)
        return self.c_proj(_attend(q, k, v, x.dtype, encoder_bias).reshape(B, Tq, D))


class MLP(nn.Module):
    def __init__(self, cfg: GPT2DecoderConfig):
        super().__init__()
        self.c_fc = Conv1D(cfg.n_embd, cfg.inner_dim)
        self.c_proj = Conv1D(cfg.inner_dim, cfg.n_embd)
        self.act = ACT[cfg.activation_function]

    def forward(self, x):
        return self.c_proj(self.act(self.c_fc(x)))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2DecoderConfig):
        super().__init__()
        D, eps = cfg.n_embd, cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(D, eps=eps)
        self.attn = SelfAttention(cfg)
        if cfg.add_cross_attention:
            self.ln_cross_attn = nn.LayerNorm(D, eps=eps)
            self.crossattention = CrossAttention(cfg)
        self.ln_2 = nn.LayerNorm(D, eps=eps)
        self.mlp = MLP(cfg)

    def forward(self, x, encoder_hidden=None, encoder_bias=None, cache: Optional[Cache] = None,
                prefix: str = ""):
        x = x + self.attn(_ln(self.ln_1, x), cache, prefix + "attn.")
        cross_ready = cache is not None and prefix + "crossattention.cached_enc_key" in cache
        if hasattr(self, "crossattention") and (encoder_hidden is not None or cross_ready):
            x = x + self.crossattention(_ln(self.ln_cross_attn, x), encoder_hidden, encoder_bias,
                                        cache if cross_ready else None, prefix + "crossattention.")
        return x + self.mlp(_ln(self.ln_2, x))


class GPT2Model(nn.Module):
    def __init__(self, cfg: GPT2DecoderConfig):
        super().__init__()
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        if not cfg.pos_emb_fixed:
            self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd)
        self.h = nn.ModuleList([GPT2Block(cfg) for _ in range(cfg.n_layer)])
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)


@dataclasses.dataclass
class DecoderOutput:
    logits: torch.Tensor  # the final head's logits (weighted with average_logits)
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None


class GPT2MultiHeadDecoder(nn.Module):
    """DeCRED decoder: GPT-2 + cross-attention + intermediate LM heads,
    computing in ``dtype``."""

    def __init__(self, config: GPT2DecoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if config.mixing_mode is not None:
            raise NotImplementedError(
                f"mixing_mode={config.mixing_mode!r} is not ported yet (the decoder's training half)")
        if config.connected_residuals:
            raise NotImplementedError(
                f"connected_residuals={config.connected_residuals!r} is not ported yet (the decoder's "
                "training half)")
        self.config = config
        self.dtype = dtype
        self.transformer = GPT2Model(config)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.n_embd, config.vocab_size, bias=False)
        if config.head_locations and not config.tie_additional_weights:
            self.additional_lm_heads = nn.ModuleList(
                [nn.Linear(config.n_embd, config.vocab_size, bias=False) for _ in config.head_locations])
        for m in self.modules():
            if isinstance(m, (Conv1D, nn.Embedding, nn.Linear)):
                m.to(dtype)
        if config.pos_emb_fixed:
            self.register_buffer("pos_table", sinusoidal_positions(config.n_positions, config.n_embd, dtype),
                                 persistent=False)

    # ---- cache
    def init_cache(self, batch: int, max_length: int, device=None) -> Cache:
        """A zeroed self-attention cache of ``max_length`` positions for
        ``batch`` rows (beam rows in a search)."""
        cfg = self.config
        shape = (batch, max_length, cfg.n_head, cfg.head_dim)
        cache: Cache = {}
        for i in range(cfg.n_layer):
            p = f"h_{i}.attn."
            cache[p + "cached_key"] = torch.zeros(shape, dtype=self.dtype, device=device)
            cache[p + "cached_value"] = torch.zeros(shape, dtype=self.dtype, device=device)
            cache[p + "cache_index"] = torch.zeros((), dtype=torch.int64, device=device)
        return cache

    def write_cross_kv(self, cache: Cache, encoder_hidden: torch.Tensor) -> Cache:
        """Each layer's cross-attention K/V from the (B, S, D) encoder state, once."""
        x = encoder_hidden.to(self.dtype)
        for i, block in enumerate(self.transformer.h):
            block.crossattention.write(cache, f"h_{i}.crossattention.", x)
        return cache

    # ---- heads
    def _head(self, k: Optional[int]):
        """The final head (k None) or additional head k, as a function of h."""
        cfg, wte = self.config, self.transformer.wte
        tied = cfg.tie_word_embeddings if k is None else cfg.tie_additional_weights
        if tied:
            return lambda h: h @ wte.weight.t()
        m = self.lm_head if k is None else self.additional_lm_heads[k]
        return lambda h: h @ m.weight.t()

    def forward(self, input_ids: torch.Tensor, encoder_hidden: Optional[torch.Tensor] = None,
                encoder_lengths: Optional[torch.Tensor] = None,
                position_offset: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None) -> DecoderOutput:
        """Without ``cache``: the whole (B, T) sequence, causally masked,
        attending to ``encoder_hidden`` (B, S, D). With ``cache``: one step
        (or ``T`` more tokens) at positions ``position_offset`` (B,); the
        cross-attention reads the cache that ``write_cross_kv`` filled, with
        ``encoder_lengths`` of the unexpanded batch. Returns the final head's
        logits (B, T, V), with ``average_logits`` plus the weighted
        intermediate heads (not divided by their count)."""
        cfg, dt = self.config, self.dtype
        tr = self.transformer
        B, T = input_ids.shape
        x = tr.wte.weight[input_ids]
        if cfg.pos_emb_fixed:
            x = x * torch.tensor(math.sqrt(cfg.n_embd), dtype=dt)
            table = self.pos_table
        else:
            table = tr.wpe.weight
        if cache is not None and position_offset is not None:
            positions = position_offset.to(torch.int64)[:, None] + torch.arange(T, device=x.device)[None, :]
            x = x + table[positions]
        else:
            x = x + table[None, :T]

        encoder_bias = None
        if encoder_lengths is not None and (encoder_hidden is not None or cache is not None):
            S = encoder_hidden.shape[1] if encoder_hidden is not None else \
                cache["h_0.crossattention.cached_enc_key"].shape[1]
            enc_mask = torch.arange(S, device=x.device)[None, :] < encoder_lengths[:, None]
            encoder_bias = torch.where(enc_mask, 0.0, NEG_INF)[:, None, None, :].float()
        enc = None if encoder_hidden is None or cache is not None else encoder_hidden.to(dt)

        # HF indexing: [0] = embeddings, [i] = block i's output, [-1] = after ln_f
        hidden_states = [x]
        for i, block in enumerate(tr.h):
            x = block(x, enc, encoder_bias, cache, f"h_{i}.")
            hidden_states.append(x)
        hidden_states[-1] = _ln(tr.ln_f, x)

        logits = self._head(None)(hidden_states[-1])
        if cfg.average_logits and cfg.head_locations:
            logits = logits * cfg.head_weights[-1]
            for k, (loc, weight) in enumerate(zip(cfg.head_locations, cfg.head_weights)):
                logits = logits + weight * self._head(k)(hidden_states[loc])
        return DecoderOutput(logits=logits, hidden_states=tuple(hidden_states))
