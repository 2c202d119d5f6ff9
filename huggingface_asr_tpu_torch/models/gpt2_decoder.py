"""GPT-2 decoder with cross-attention and intermediate LM heads, the DeCRED
decoder (counterpart of ``huggingface_asr_tpu/models/gpt2_decoder.py``).

Module attribute names follow the HF keys that
``huggingface_asr_tpu/interop/export_hf.py::export_gpt2_decoder`` writes
(``transformer.h.{i}.attn.c_attn``, ``lm_head``, ``additional_lm_heads.{k}``,
``lm_mixing``), so a converted checkpoint loads with
``load_state_dict(strict=True)``. GPT-2 ``Conv1D`` weights are stored (in,
out); ``lm_head``, the additional heads and the "full" ``lm_mixing`` are
``nn.Linear`` (out, in).

The decoder computes in its ``dtype`` and casts each parameter to it at its
use, as the Flax modules cast their fp32 parameters. Where the parameters
are held is ``param_dtype``: by default (serving) the weights of the
products, the embedding tables, the heads and the mixing weights are held in
``dtype`` from construction on (``load_state_dict`` and ``init_random_`` round
into them once, to the values a cast at use gives), so a decode step casts
none; a trainer builds the decoder with ``param_dtype=torch.float32``, the
fp32 master weights its optimizer updates. Both layouts compute the same
function. LayerNorm parameters stay fp32; its statistics and the softmax are
fp32. Attention keeps the JAX order of roundings: scores in the model dtype
divided by ``sqrt(dh)`` cast to that dtype, fp32 from the mask bias on, the
probabilities cast back before P.V.

Training is a forward with ``labels`` and ``label_mask`` (the loss, each
head's label-smoothed cross entropy weighted by ``head_weights``) and, for
dropout, ``rng`` (a ``DropoutRng``) at the Flax sites: the embeddings, the
attention probabilities after their cast, each attention's and the MLP's
output projection. The head options: intermediate heads (``head_locations``,
with ``average_logits``), a learned mixing of the heads' logits
(``mixing_mode`` "full", "linear" or "scalar") and an LM head over the
concatenation of chosen hidden states (``connected_residuals``).

Incremental decoding keeps its state in an explicit cache (a flat dict of
tensors, ``init_cache``): per layer a fixed-size self-attention K/V buffer of
``max_length`` rows with a write index on the device, and the
cross-attention K/V written once from the unexpanded (B, S, D) encoder state
(``write_cross_kv``) and shared by the W beams of each batch element. Every
buffer keeps its shape for the whole search.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng, _lecun_normal, _ln
from huggingface_asr_tpu_torch.parallel.mesh import global_sum

NEG_INF = torch.finfo(torch.float32).min

Cache = Dict[str, torch.Tensor]

MIXING_MODES = ("full", "linear", "scalar")


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
    # None | "full" (a Linear over the concatenated heads' logits) | "linear"
    # (per head and vocabulary entry) | "scalar" (per head)
    mixing_mode: Optional[str] = None
    # LM head over the concatenation of these hidden states; empty = off
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

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


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


def smoothed_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """The mean cross entropy over the masked tokens, with torch-style label
    smoothing (``(1 - ls) * nll + ls * mean_v(-log p_v)``), in fp32; the
    denominator is ``max(sum(mask), 1)``, the global batch's tokens in a
    data-parallel step (``parallel/mesh.py``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * -logp.mean(dim=-1)
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(global_sum(mask.sum()), min=1.0)


def _drop(rng: Optional[DropoutRng], x: torch.Tensor, rate: float) -> torch.Tensor:
    return x if rng is None else rng.dropout(x, rate)


class Conv1D(nn.Module):
    """GPT-2's dense layer: weight stored (in, out)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # product, then bias: the Flax Dense's two roundings in a low-precision dtype
        return x @ self.weight.to(x.dtype) + self.bias.to(x.dtype)


def _attend(q, k, v, dtype, bias, rng=None, rate=0.0):
    """softmax((q k^T) / sqrt(dh) + bias) v over (B, Tq, H, dh) queries and
    (B, Tk, H, dh) keys/values; ``bias`` broadcasts to (B, H, Tq, Tk) fp32;
    the probabilities' dropout after their cast."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(math.sqrt(dh), dtype=dtype)
    scores = scores.float()
    if bias is not None:
        scores = scores + bias
    probs = _drop(rng, torch.softmax(scores, dim=-1).to(dtype), rate)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class SelfAttention(nn.Module):
    """Causal self-attention, whole sequence or one cached step."""

    def __init__(self, cfg: GPT2DecoderConfig):
        super().__init__()
        D = cfg.n_embd
        self.H, self.dh = cfg.n_head, cfg.head_dim
        self.attn_pdrop, self.resid_pdrop = cfg.attn_pdrop, cfg.resid_pdrop
        self.c_attn = Conv1D(D, 3 * D)
        self.c_proj = Conv1D(D, D)

    def forward(self, x, cache: Optional[Cache] = None, prefix: str = "", rng: Optional[DropoutRng] = None):
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
        out = _attend(q, k, v, x.dtype, bias, rng, self.attn_pdrop).reshape(B, Tq, D)
        return _drop(rng, self.c_proj(out), self.resid_pdrop)


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
        self.attn_pdrop, self.resid_pdrop = cfg.attn_pdrop, cfg.resid_pdrop
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
                prefix: str = "", rng: Optional[DropoutRng] = None):
        B, Tq, D = x.shape
        q = self.q_attn(x)
        if cache is not None:  # the beam-shared read: a decode step, never a training forward
            k, v = cache[prefix + "cached_enc_key"], cache[prefix + "cached_enc_value"]
            rng = None
        else:
            k, v = self.kv(encoder_hidden)
        W = B // k.shape[0]
        q = q.reshape(k.shape[0], W * Tq, self.H, self.dh)
        out = _attend(q, k, v, x.dtype, encoder_bias, rng, self.attn_pdrop).reshape(B, Tq, D)
        return _drop(rng, self.c_proj(out), self.resid_pdrop)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2DecoderConfig):
        super().__init__()
        self.c_fc = Conv1D(cfg.n_embd, cfg.inner_dim)
        self.c_proj = Conv1D(cfg.inner_dim, cfg.n_embd)
        self.act = ACT[cfg.activation_function]
        self.resid_pdrop = cfg.resid_pdrop

    def forward(self, x, rng: Optional[DropoutRng] = None):
        return _drop(rng, self.c_proj(self.act(self.c_fc(x))), self.resid_pdrop)


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
                prefix: str = "", rng: Optional[DropoutRng] = None):
        x = x + self.attn(_ln(self.ln_1, x), cache, prefix + "attn.", rng)
        cross_ready = cache is not None and prefix + "crossattention.cached_enc_key" in cache
        if hasattr(self, "crossattention") and (encoder_hidden is not None or cross_ready):
            x = x + self.crossattention(_ln(self.ln_cross_attn, x), encoder_hidden, encoder_bias,
                                        cache if cross_ready else None, prefix + "crossattention.", rng)
        return x + self.mlp(_ln(self.ln_2, x), rng)


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
    # the final head's logits (weighted with average_logits; the mixed logits
    # with mixing_mode; the residual head's with connected_residuals)
    logits: torch.Tensor
    loss: Optional[torch.Tensor] = None
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None
    per_head_logits: Optional[Tuple[torch.Tensor, ...]] = None


class GPT2MultiHeadDecoder(nn.Module):
    """DeCRED decoder: GPT-2 + cross-attention + intermediate LM heads,
    computing in ``dtype``, its weights held in ``param_dtype`` (default
    ``dtype``)."""

    def __init__(self, config: GPT2DecoderConfig, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if config.mixing_mode not in (None,) + MIXING_MODES:
            raise NotImplementedError(f"mixing_mode={config.mixing_mode!r}: None or one of {MIXING_MODES}")
        self.config = config
        self.dtype = dtype
        self.transformer = GPT2Model(config)
        V, D = config.vocab_size, config.n_embd
        if config.connected_residuals:
            # the residual classifier: one head over the concatenated states, no other head
            self.lm_head = nn.Linear(len(config.connected_residuals) * D, V, bias=False)
        else:
            if not config.tie_word_embeddings:
                self.lm_head = nn.Linear(D, V, bias=False)
            if config.head_locations and not config.tie_additional_weights:
                self.additional_lm_heads = nn.ModuleList(
                    [nn.Linear(D, V, bias=False) for _ in config.head_locations])
            n = len(config.head_weights)
            if config.mixing_mode == "full":
                self.lm_mixing = nn.Linear(n * V, V)
            elif config.mixing_mode == "linear":
                self.lm_mixing = nn.Parameter(torch.full((n, V), 1.0 / n))
            elif config.mixing_mode == "scalar":
                self.lm_mixing = nn.Parameter(torch.full((n,), 1.0 / n))
        held = dtype if param_dtype is None else param_dtype
        for m in self.modules():
            if isinstance(m, (Conv1D, nn.Embedding, nn.Linear)):
                m.to(held)
        if isinstance(getattr(self, "lm_mixing", None), nn.Parameter):
            self.lm_mixing.data = self.lm_mixing.data.to(held)
        if config.pos_emb_fixed:
            self.register_buffer("pos_table", sinusoidal_positions(config.n_positions, config.n_embd, held),
                                 persistent=False)

    @property
    def num_heads(self) -> int:
        """The heads the loss and the mixing see: the intermediate ones, then
        the final one (as many as ``head_weights`` has, at most)."""
        cfg = self.config
        return min(len(cfg.head_locations) + 1, len(cfg.head_weights))

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
        m = wte if tied else self.lm_head if k is None else self.additional_lm_heads[k]
        return lambda h: h @ m.weight.to(h.dtype).t()

    def _heads(self):
        """(hidden-state index, head) of each head, the final one last."""
        cfg = self.config
        locs = [*cfg.head_locations, -1][:self.num_heads]
        return [(loc, self._head(None if k == len(cfg.head_locations) else k)) for k, loc in enumerate(locs)]

    def _mix(self, per_head):
        """The mixed logits of ``mixing_mode`` over the heads' logits."""
        mode, w = self.config.mixing_mode, self.lm_mixing
        if mode == "full":
            x = torch.cat(per_head, dim=-1)
            return x @ w.weight.to(x.dtype).t() + w.bias.to(x.dtype)
        if mode == "linear":
            return sum(lg * w[i][None, None, :].to(lg.dtype) for i, lg in enumerate(per_head))
        return sum(lg * w[i].to(lg.dtype) for i, lg in enumerate(per_head))

    def forward(self, input_ids: torch.Tensor, encoder_hidden: Optional[torch.Tensor] = None,
                encoder_lengths: Optional[torch.Tensor] = None,
                position_offset: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, labels: Optional[torch.Tensor] = None,
                label_mask: Optional[torch.Tensor] = None, rng: Optional[DropoutRng] = None,
                embeds_overlay: Optional[torch.Tensor] = None,
                overlay_mask: Optional[torch.Tensor] = None) -> DecoderOutput:
        """Without ``cache``: the whole (B, T) sequence, causally masked,
        attending to ``encoder_hidden`` (B, S, D). With ``cache``: one step
        (or ``T`` more tokens) at positions ``position_offset`` (B,); the
        cross-attention reads the cache that ``write_cross_kv`` filled, with
        ``encoder_lengths`` of the unexpanded batch.

        ``labels`` (B, T), aligned with the input positions, and
        ``label_mask`` (B, T): the loss. Without a mixing or residual head it
        is the sum of each head's smoothed cross entropy weighted by
        ``head_weights``, and ``average_logits`` returns the fp32 weighted sum
        of the heads' logits divided by their count; the mixed logits' loss
        has no smoothing. Without labels the final head's logits (B, T, V),
        with ``average_logits`` plus the weighted intermediate heads (not
        divided by their count), as the JAX decoder has the two forms.
        ``rng``: the training forward's dropout stream. ``embeds_overlay``
        (B, T, D) and ``overlay_mask`` (B, T): the flagged positions take the
        overlay, cast to the model dtype, in place of their token embedding
        (LLM-ASR's soft prompts and projected frames)."""
        cfg, dt = self.config, self.dtype
        tr = self.transformer
        B, T = input_ids.shape
        x = tr.wte.weight[input_ids].to(dt)
        if embeds_overlay is not None:
            x = torch.where(overlay_mask[..., None], embeds_overlay.to(dt), x)
        if cfg.pos_emb_fixed:
            x = x * torch.tensor(math.sqrt(cfg.n_embd), dtype=dt)
            table = self.pos_table
        else:
            table = tr.wpe.weight
        if cache is not None and position_offset is not None:
            positions = position_offset.to(torch.int64)[:, None] + torch.arange(T, device=x.device)[None, :]
            x = x + table[positions].to(dt)
        else:
            x = x + table[None, :T].to(dt)
        x = _drop(rng, x, cfg.embd_pdrop)

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
            x = block(x, enc, encoder_bias, cache, f"h_{i}.", rng)
            hidden_states.append(x)
        hidden_states[-1] = _ln(tr.ln_f, x)
        hs = tuple(hidden_states)

        def loss_of(logits, smoothing):
            return None if labels is None else smoothed_cross_entropy(logits, labels, label_mask, smoothing)

        if cfg.connected_residuals:
            concat = torch.cat([hs[i] for i in cfg.connected_residuals], dim=-1)
            logits = concat @ self.lm_head.weight.to(dt).t()
            return DecoderOutput(logits=logits, loss=loss_of(logits, cfg.lsm_factor), hidden_states=hs)
        if cfg.mixing_mode is not None:
            per_head = tuple(head(hs[loc]) for loc, head in self._heads())
            logits = self._mix(per_head)
            return DecoderOutput(logits=logits, loss=loss_of(logits, 0.0), hidden_states=hs,
                                 per_head_logits=per_head)
        if labels is not None:
            per_head = tuple(head(hs[loc]) for loc, head in self._heads())
            loss = sum(w * smoothed_cross_entropy(lg, labels, label_mask, cfg.lsm_factor)
                       for w, lg in zip(cfg.head_weights, per_head))
            logits = per_head[-1]
            if cfg.average_logits:
                w = torch.tensor(cfg.head_weights, dtype=torch.float32, device=x.device)
                logits = sum(w[i] * lg.float() for i, lg in enumerate(per_head)) / len(per_head)
            return DecoderOutput(logits=logits, loss=loss, hidden_states=hs, per_head_logits=per_head)

        logits = self._head(None)(hs[-1])
        if cfg.average_logits and cfg.head_locations:
            logits = logits * cfg.head_weights[-1]
            for k, (loc, weight) in enumerate(zip(cfg.head_locations, cfg.head_weights)):
                logits = logits + weight * self._head(k)(hs[loc])
        return DecoderOutput(logits=logits, hidden_states=hs)


@torch.no_grad()
def init_decoder_from_scratch_(model: GPT2MultiHeadDecoder, generator: torch.Generator) -> GPT2MultiHeadDecoder:
    """The distributions of the JAX package's ``GPT2MultiHeadDecoder.init``
    (HF GPT-2's): every ``Conv1D`` weight and LM head ~ N(0, 0.02^2), the
    output projections of the attentions and the MLP (``c_proj``) ~ N(0,
    (0.02 / sqrt(2 n_layer))^2), ``wte`` ~ N(0, 0.02^2), ``wpe`` ~ N(0,
    0.01^2), LayerNorms 1 and 0, biases 0. The residual classifier's
    ``lm_head`` keeps Flax's default lecun_normal; the mixing weights start at
    0.5 I tiled over the heads ("full", bias 0) or 1/n ("linear", "scalar").
    The draws come from ``generator`` on the CPU, in ``named_parameters``
    order, and are copied into place."""
    cfg = model.config
    std, std_resid = 0.02, 0.02 / math.sqrt(2 * cfg.n_layer)
    normal = lambda p, s: p.copy_(s * torch.randn(p.shape, generator=generator, dtype=torch.float32))  # noqa: E731
    for name, p in model.named_parameters():
        if ".ln_" in name:
            p.fill_(1.0 if name.endswith(".weight") else 0.0)
        elif name.endswith(".bias"):
            p.zero_()
        elif name == "transformer.wpe.weight":
            normal(p, 0.01)
        elif name.endswith("c_proj.weight"):
            normal(p, std_resid)
        elif name == "lm_head.weight" and cfg.connected_residuals:
            p.copy_(_lecun_normal(p.shape, p.shape[1], generator))
        elif name == "lm_mixing.weight":
            V = cfg.vocab_size
            p.copy_(0.5 * torch.eye(V).repeat(1, p.shape[1] // V))
        elif name == "lm_mixing":
            p.fill_(1.0 / len(cfg.head_weights))
        else:
            normal(p, std)
    return model
