"""Frame-synchronous CTC prefix beam search, batched, on the device
(counterpart of ``huggingface_asr_tpu/decoding/ctc_beam.py``).

The classic prefix beam search (p_blank / p_non-blank per prefix, Hannun et
al.) vectorised over batch x beam in one loop over frames, with static shapes
throughout:

  * per-frame top-K token pruning (``beam_size_token``);
  * exact merging of duplicate prefixes through two 32-bit rolling hashes:
    the candidate pool is sorted by (h1, h2) and equal neighbours are
    log-sum-exp merged before the top-W selection;
  * padded frames freeze the state.

Where the JAX package's semantics meet PyTorch's:

  * the hashes are uint32 arithmetic; they live in int64 here, every
    multiply-add reduced to its low 32 bits, and the product is taken in two
    16-bit halves of the hash so that no int64 product overflows
    (``_hash_step``);
  * ``jnp.lexsort((h2, h1))`` is two stable sorts, by h2 and then by h1;
  * ``jax.lax.top_k`` and ``jnp.argsort`` put the lower index first among
    equal values: both are stable descending (or ascending) sorts here,
    which do the same (``torch.topk`` promises no order among ties).

Plain PyTorch on every device: the JAX function holds no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

NEG_INF = -1.0e9
_H1_MULT = 1000003
_H2_MULT = 2654435761
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CTCBeamConfig:
    beam_size: int = 10  # W
    beam_size_token: int = 16  # per-frame top-K tokens considered
    blank_id: int = -1
    max_tokens: int = 256  # output length cap


def _hash_step(h: torch.Tensor, mult: int, c: torch.Tensor) -> torch.Tensor:
    """``uint32(h * mult + c + 1)`` on int64 tensors holding uint32 values:
    ``h * mult`` as ``h_lo * mult + (h_hi * mult mod 2^16) * 2^16`` (both
    products below 2^48), reduced mod 2^32."""
    lo, hi = h & 0xFFFF, h >> 16
    prod = lo * mult + (((hi * mult) & 0xFFFF) << 16)
    return (prod + c + 1) & _MASK32


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.clamp(torch.maximum(a, b), min=NEG_INF)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, the lower index first among equals
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx)


def ctc_beam_search(log_probs: torch.Tensor, lengths: torch.Tensor, config: CTCBeamConfig = CTCBeamConfig()
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, V) log-softmaxed CTC posteriors, (B,) frame lengths -> (tokens
    (B, W, L) int32, token lengths (B, W) int32, scores (B, W) float32), best
    first, on the posteriors' device."""
    cfg = config
    B, T, V = log_probs.shape
    W, K, L = cfg.beam_size, min(cfg.beam_size_token, V), cfg.max_tokens
    blank = cfg.blank_id % V
    dev = log_probs.device
    log_probs = log_probs.float()
    lengths = lengths.to(dev)
    i64 = dict(dtype=torch.int64, device=dev)

    tokens = torch.zeros(B, W, L, **i64)
    tok_len = torch.zeros(B, W, **i64)
    last = torch.full((B, W), -1, **i64)
    h1 = torch.zeros(B, W, **i64)
    h2 = torch.zeros(B, W, **i64)
    p_b = torch.full((B, W), NEG_INF, dtype=torch.float32, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((B, W), NEG_INF, dtype=torch.float32, device=dev)

    N = W + W * K
    src_beam = torch.cat([torch.arange(W, **i64), torch.arange(W, **i64).repeat_interleave(K)])[None].expand(B, N)
    positions = torch.arange(L, **i64)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    for t in range(T):
        lp_t = log_probs[:, t]  # (B, V)
        top_lp, top_ids = _top(lp_t, K)  # (B, K)
        lp_blank = lp_t[:, blank]
        p_tot = _lse(p_b, p_nb)  # (B, W)

        # "stay" candidates (the same prefix): the blank path and the repeat path
        stay_p_b = p_tot + lp_blank[:, None]
        lp_last = _take(lp_t, torch.clamp(last, min=0))
        stay_p_nb = torch.where(last >= 0, p_nb + lp_last, neg)

        # "extend" candidates (B, W, K)
        c = top_ids[:, None, :].expand(B, W, K)
        is_rep = c == last[:, :, None]
        base = torch.where(is_rep, p_b[:, :, None], p_tot[:, :, None])
        ext_p_nb = torch.where(c == blank, neg, base + top_lp[:, None, :])
        ext_h1 = _hash_step(h1[:, :, None], _H1_MULT, c)
        ext_h2 = _hash_step(h2[:, :, None], _H2_MULT, c)

        # the pool: W stay + W*K extend; provenance: source beam, appended token (-1 none)
        cand_h1 = torch.cat([h1, ext_h1.reshape(B, W * K)], dim=1)
        cand_h2 = torch.cat([h2, ext_h2.reshape(B, W * K)], dim=1)
        cand_p_b = torch.cat([stay_p_b, torch.full((B, W * K), NEG_INF, device=dev)], dim=1)
        cand_p_nb = torch.cat([stay_p_nb, ext_p_nb.reshape(B, W * K)], dim=1)
        app_tok = torch.cat([torch.full((B, W), -1, **i64), c.reshape(B, W * K)], dim=1)

        # merge duplicates: sort by (h1, h2) (lexsort: by h2, then stably by h1),
        # log-sum-exp each run of equal hashes into its first member
        o2 = torch.sort(cand_h2, dim=1, stable=True).indices
        o1 = torch.sort(_take(cand_h1, o2), dim=1, stable=True).indices
        order = _take(o2, o1)
        s_h1, s_h2 = _take(cand_h1, order), _take(cand_h2, order)
        s_p_b, s_p_nb = _take(cand_p_b, order), _take(cand_p_nb, order)
        s_src, s_app = _take(src_beam, order), _take(app_tok, order)

        same_as_prev = torch.zeros(B, N, dtype=torch.bool, device=dev)
        same_as_prev[:, 1:] = (s_h1[:, 1:] == s_h1[:, :-1]) & (s_h2[:, 1:] == s_h2[:, :-1])
        seg = torch.cumsum((~same_as_prev).to(torch.int64), dim=1) - 1  # (B, N)

        def merged(p):
            mx = torch.full((B, N), NEG_INF, device=dev).scatter_reduce(1, seg, p, "amax", include_self=True)
            sums = torch.zeros(B, N, device=dev).scatter_add(1, seg, torch.exp(p - _take(mx, seg)))
            return _take(mx + torch.log(torch.clamp(sums, min=1e-30)), seg)

        first = ~same_as_prev
        m_p_b = torch.where(first, merged(s_p_b), neg)
        m_p_nb = torch.where(first, merged(s_p_nb), neg)

        _, top_pos = _top(_lse(m_p_b, m_p_nb), W)  # (B, W)
        sel_src, sel_app = _take(s_src, top_pos), _take(s_app, top_pos)
        old_tokens = torch.gather(tokens, 1, sel_src[..., None].expand(B, W, L))
        old_len = _take(tok_len, sel_src)
        old_last = _take(last, sel_src)
        appended = sel_app >= 0
        pos_mask = (positions[None, None, :] == torch.clamp(old_len, 0, L - 1)[..., None]) & appended[..., None]

        # frames past an utterance's length freeze its state
        active = (t < lengths)[:, None]
        tokens = torch.where(active[..., None], torch.where(pos_mask, sel_app[..., None], old_tokens), tokens)
        tok_len = torch.where(active, old_len + appended.to(torch.int64), tok_len)
        last = torch.where(active, torch.where(appended, sel_app, old_last), last)
        h1 = torch.where(active, _take(s_h1, top_pos), h1)
        h2 = torch.where(active, _take(s_h2, top_pos), h2)
        p_b = torch.where(active, _take(m_p_b, top_pos), p_b)
        p_nb = torch.where(active, _take(m_p_nb, top_pos), p_nb)

    scores = _lse(p_b, p_nb)
    order = torch.sort(-scores, dim=1, stable=True).indices
    tokens = torch.gather(tokens, 1, order[..., None].expand(B, W, L))
    return tokens.to(torch.int32), _take(tok_len, order).to(torch.int32), _take(scores, order)
