"""Batched joint CTC/attention beam search with shallow fusion
(counterpart of ``huggingface_asr_tpu/decoding/beam_search.py``).

    next_token_score = (1 - ctc_weight) * log_softmax(att)
                       + ctc_weight * ctc_prefix_score
                       + lm_weight * log_softmax(lm)

Each step: the KV-cached decoder (and LM) step, per-beam candidates (the
top-(K-1) of the attention (+ LM) score and eos), CTC prefix scores of those
candidates, the top 2W of the batch element's W*K totals, and HF's
alive/finished bookkeeping with its length-penalty convention (score =
sum of log-probs / len(hyp) ** penalty, the hypothesis counting the start
token). A batch element that HF would call done is frozen. Score components
(att/ctc/lm) travel with the hypotheses.

Every selection takes the lower index first among equal scores, as
``lax.top_k`` does (``_top_k``: a stable sort of the scores, descending).
Ties do occur: dead beams start at ``NEG_INF`` and a duplicated eos column is
set to ``NEG_INF``. Every buffer keeps its shape for the whole search.

The JAX search is one compiled loop whose ``early_exit`` test runs on the
device; here the loop runs on the host, and with ``early_exit`` each step's
test of ``all(done)`` is one device-to-host read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from huggingface_asr_tpu_torch.decoding.ctc_prefix import CTCPrefixScorer, CTCPrefixState

NEG_INF = -1.0e9


@dataclasses.dataclass(frozen=True)
class BeamSearchConfig:
    """The JAX package's fields and defaults, but for its two TPU options of
    an approximate top-k (``approx_candidate_topk``, ``approx_topk_recall``):
    on the CPU and the GPU its selection is exact, and so is this one.
    ``ctc_margin`` is accepted and inert, as it is there (and in the
    reference's generate path)."""

    num_beams: int = 5
    max_length: int = 128
    ctc_weight: float = 0.3
    ctc_margin: int = 0
    lm_weight: float = 0.0
    length_penalty: float = 1.0
    num_candidates: int = 64  # per-beam attention top-K scored by CTC
    bos_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 3
    blank_id: int = -1  # index into the CTC logits; -1 = last
    apply_eos_space_trick: bool = False
    space_token_id: int = -1
    eos_space_trick_weight: float = 1.0
    return_components: bool = False  # also return the att/ctc/lm score breakdown
    early_exit: bool = True


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, best first; equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_eos_space_trick_scores(combined: torch.Tensor, cand_ids: torch.Tensor, cand_att: torch.Tensor,
                                 cand_ctc: torch.Tensor, *, eos_token_id: int, space_token_id: int,
                                 weight: float) -> torch.Tensor:
    """The reference's eos-space trick over a candidate set: per beam row,
    when attention's best candidate is eos and CTC's is space, and the mixed
    eos score loses to space while ``weight * eos`` would win, the mixed eos
    score is multiplied by ``weight``. All arguments are (BW, K)."""
    att_argmax = cand_ids.gather(1, cand_att.argmax(dim=1, keepdim=True))[:, 0]
    ctc_argmax = cand_ids.gather(1, cand_ctc.argmax(dim=1, keepdim=True))[:, 0]
    is_eos_col = cand_ids == eos_token_id
    eos_score = torch.where(is_eos_col, combined, NEG_INF).amax(dim=1)
    space_score = torch.where(cand_ids == space_token_id, combined, NEG_INF).amax(dim=1)
    conflict = ((att_argmax == eos_token_id) & (ctc_argmax == space_token_id)
                & (eos_score < space_score) & (weight * eos_score > space_score))
    return torch.where(conflict[:, None] & is_eos_col, combined * weight, combined)


def _gather_beams(cache: Optional[Dict[str, torch.Tensor]], beam_idx_flat: torch.Tensor):
    """Reorder the (B*W, ...) entries of a cache by flat beam indices. The
    cross-attention K/V (``cached_enc_*``) are shared by the beams of a batch
    element and stay as they are; so do the write indices (0-d)."""
    if cache is None:
        return None
    n = beam_idx_flat.shape[0]
    return {k: v.index_select(0, beam_idx_flat)
            if "cached_enc" not in k and v.ndim >= 1 and v.shape[0] == n else v
            for k, v in cache.items()}


class _BeamState(NamedTuple):
    alive_tokens: torch.Tensor  # (B, W, L)
    alive_scores: torch.Tensor  # (B, W) combined sum of log-probs
    alive_components: torch.Tensor  # (B, W, 3) cumulative [att, ctc, lm]
    cache: Any
    lm_cache: Any
    ctc_state: Optional[CTCPrefixState]
    finished_tokens: torch.Tensor  # (B, W, L)
    finished_scores: torch.Tensor  # (B, W) length-penalized
    finished_components: torch.Tensor  # (B, W, 3)
    finished_mask: torch.Tensor  # (B, W) slot filled
    done: torch.Tensor  # (B,) HF is_done: the batch element is frozen


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) at idx (B, M) along axis 1."""
    return x.gather(1, idx.view(idx.shape + (1,) * (x.ndim - 2)).expand(idx.shape + x.shape[2:]))


def joint_beam_search(
    decoder_step: Callable[[Any, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, Any]],
    init_cache: Any,
    batch_size: int,
    config: BeamSearchConfig,
    ctc_log_probs: Optional[torch.Tensor] = None,  # (B, T, V+1)
    ctc_lengths: Optional[torch.Tensor] = None,
    lm_step: Optional[Callable] = None,
    init_lm_cache: Any = None,
    vocab_size: Optional[int] = None,
    hook: Optional[Callable[..., None]] = None,
):
    """Run the beam search.

    decoder_step(cache, tokens (BW, 1), positions (BW,)) -> (logits (BW, V), cache).
    Returns (sequences (B, W, L) best first, starting with bos; scores (B, W)),
    and a dict {"att", "ctc", "lm"} of (B, W) components with
    ``config.return_components``. ``hook``, where given, is called with
    "decoder", "ctc" and "select" before each part of a step is issued (a
    profiler's marks; one "decoder" call per step taken, which also passes
    the (B, W, L) alive tokens the step starts from)."""
    cfg = config
    B, W, K, L = batch_size, config.num_beams, config.num_candidates, config.max_length
    BW = B * W
    mark = hook or (lambda name, alive=None: None)

    use_ctc = cfg.ctc_weight > 0.0 and ctc_log_probs is not None
    use_lm = lm_step is not None and cfg.lm_weight != 0.0
    scorer = None
    if use_ctc:
        V_ctc = ctc_log_probs.shape[-1]
        scorer = CTCPrefixScorer(ctc_log_probs, ctc_lengths, cfg.blank_id % V_ctc, cfg.eos_token_id)
        vocab_size = vocab_size or V_ctc - 1
        dev = ctc_log_probs.device
    else:
        dev = next(v for v in init_cache.values()).device

    f32, i64 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int64, device=dev)
    alive_tokens = torch.full((B, W, L), cfg.pad_token_id, **i64)
    alive_tokens[:, :, 0] = cfg.bos_token_id
    state = _BeamState(
        alive_tokens=alive_tokens,
        alive_scores=torch.tensor([0.0] + [NEG_INF] * (W - 1), **f32).repeat(B, 1),
        alive_components=torch.zeros(B, W, 3, **f32),
        cache=init_cache,
        lm_cache=init_lm_cache,
        ctc_state=scorer.init_state(W) if use_ctc else None,
        finished_tokens=torch.full((B, W, L), cfg.pad_token_id, **i64),
        finished_scores=torch.full((B, W), NEG_INF, **f32),
        finished_components=torch.zeros(B, W, 3, **f32),
        finished_mask=torch.zeros(B, W, dtype=torch.bool, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
    )
    positions_of = torch.arange(L, **i64)
    rank_lt_w = torch.arange(2 * W, device=dev)[None, :] < W
    batch_base = torch.arange(B, device=dev)[:, None] * W

    def one_step(state: _BeamState, t: int) -> _BeamState:
        last_tokens = state.alive_tokens.reshape(BW, L)[:, t:t + 1]
        positions = torch.full((BW,), t, **i64)

        mark("decoder", state.alive_tokens)
        logits, new_cache = decoder_step(state.cache, last_tokens, positions)
        att = F.log_softmax(logits.float(), dim=-1)
        if vocab_size is not None and att.shape[-1] > vocab_size:
            att = att[:, :vocab_size]
        att[:, cfg.pad_token_id] = NEG_INF  # pad is never a candidate
        if K - 1 > att.shape[-1]:
            raise ValueError(f"num_candidates {K} needs a vocabulary of at least {K - 1}, got {att.shape[-1]}")

        new_lm_cache, lm_lp, select_scores = state.lm_cache, None, att
        if use_lm:
            lm_logits, new_lm_cache = lm_step(state.lm_cache, last_tokens, positions)
            lm_lp = F.log_softmax(lm_logits.float(), dim=-1)[:, :att.shape[-1]]
            select_scores = att + cfg.lm_weight * lm_lp

        # per-beam candidates: the top-(K-1) of the non-CTC score, and eos
        _, cand_ids = _top_k(select_scores, K - 1)
        has_eos = (cand_ids == cfg.eos_token_id).any(dim=-1, keepdim=True)
        cand_ids = torch.cat([cand_ids, torch.full((BW, 1), cfg.eos_token_id, **i64)], dim=1)  # (BW, K)
        cand_att = att.gather(1, cand_ids)
        cand_lm = lm_lp.gather(1, cand_ids) if use_lm else torch.zeros_like(cand_att)
        # the appended eos column, where eos is a candidate already
        dup = torch.cat([torch.zeros(BW, K - 1, dtype=torch.bool, device=dev), has_eos], dim=1)
        cand_att = torch.where(dup, NEG_INF, cand_att)

        if use_ctc:
            mark("ctc")
            cand_ctc, scored = scorer.score_candidates(state.ctc_state, cand_ids)
            combined = (1.0 - cfg.ctc_weight) * cand_att + cfg.ctc_weight * cand_ctc + cfg.lm_weight * cand_lm
            if cfg.apply_eos_space_trick:
                combined = apply_eos_space_trick_scores(
                    combined, cand_ids, cand_att, cand_ctc, eos_token_id=cfg.eos_token_id,
                    space_token_id=cfg.space_token_id, weight=cfg.eos_space_trick_weight)
        else:
            cand_ctc, scored = torch.zeros_like(cand_att), None
            combined = cand_att + cfg.lm_weight * cand_lm

        mark("select")
        total_b = (state.alive_scores.reshape(BW, 1) + combined).reshape(B, W * K)
        # the top 2W, so that eos picks do not starve the alive set
        top_scores, top_idx = _top_k(total_b, 2 * W)
        beam_of, cand_of = top_idx // K, top_idx % K
        at_top = lambda x: x.reshape(B, W * K).gather(1, top_idx)  # noqa: E731
        tok_of = at_top(cand_ids)
        comp_of = torch.stack([at_top(cand_att), at_top(cand_ctc), at_top(cand_lm)], dim=-1)  # (B, 2W, 3)
        new_components = _take(state.alive_components, beam_of) + comp_of
        is_eos = tok_of == cfg.eos_token_id

        # the finished set, as HF's BeamSearchScorer.process: only eos
        # candidates ranked below W enter, and the length-penalty denominator
        # is bos + generated tokens without the eos, t + 1
        eos_eligible = is_eos & rank_lt_w
        lp_den = float(t + 1) ** cfg.length_penalty
        fin_cand_scores = torch.where(eos_eligible, top_scores / lp_den, NEG_INF)
        onehot_t1 = (positions_of == t + 1)[None, None, :]
        fin_cand_tokens = torch.where(onehot_t1, cfg.eos_token_id, _take(state.alive_tokens, beam_of))
        all_fin_scores = torch.cat([state.finished_scores, fin_cand_scores], dim=1)
        all_fin_tokens = torch.cat([state.finished_tokens, fin_cand_tokens], dim=1)
        all_fin_components = torch.cat([state.finished_components, new_components], dim=1)
        all_fin_mask = torch.cat([state.finished_mask, eos_eligible], dim=1)
        fin_top, fin_idx = _top_k(torch.where(all_fin_mask, all_fin_scores, NEG_INF), W)

        # the new alive set: the best W candidates that are not eos
        alv_top, alv_idx = _top_k(torch.where(is_eos, NEG_INF, top_scores), W)
        alv_beam, alv_cand, alv_tok = (x.gather(1, alv_idx) for x in (beam_of, cand_of, tok_of))
        new_alive_tokens = torch.where(onehot_t1, alv_tok[..., None], _take(state.alive_tokens, alv_beam))

        beam_flat = (batch_base + alv_beam).reshape(BW)
        new_cache = _gather_beams(new_cache, beam_flat)
        if use_lm:
            new_lm_cache = _gather_beams(new_lm_cache, beam_flat)
        new_ctc_state = state.ctc_state
        if use_ctc:
            new_ctc_state = scorer.select_state(state.ctc_state, scored, beam_flat, alv_cand.reshape(BW),
                                                alv_tok.reshape(BW))

        # HF is_done (early_stopping=False): the finished set is full and its
        # worst score is at least the best continuation's bound. A batch
        # element done at the start of this step takes none of its updates.
        new_finished_mask = _take(all_fin_mask, fin_idx)
        worst_fin = torch.where(new_finished_mask, fin_top, NEG_INF).amin(dim=1)
        done_now = new_finished_mask.all(dim=1) & (worst_fin >= top_scores.amax(dim=1) / lp_den)
        frozen = state.done

        def keep(old, new):
            return torch.where(frozen.view((B,) + (1,) * (new.ndim - 1)), old, new)

        return _BeamState(
            alive_tokens=keep(state.alive_tokens, new_alive_tokens),
            alive_scores=keep(state.alive_scores, alv_top),
            alive_components=keep(state.alive_components, _take(new_components, alv_idx)),
            cache=new_cache,
            lm_cache=new_lm_cache,
            ctc_state=new_ctc_state,
            finished_tokens=keep(state.finished_tokens, _take(all_fin_tokens, fin_idx)),
            finished_scores=keep(state.finished_scores, fin_top),
            finished_components=keep(state.finished_components, _take(all_fin_components, fin_idx)),
            finished_mask=keep(state.finished_mask, new_finished_mask),
            done=state.done | done_now,
        )

    for t in range(L - 1):
        # done-freezing makes stopping here result-identical to running on
        if cfg.early_exit and bool(state.done.all()):
            break
        state = one_step(state, t)

    # fold the alive beams in for batch elements with open slots (HF's
    # finalize skips done ones: their alive beams are stale)
    alive_final = torch.where(state.done[:, None], NEG_INF,
                              state.alive_scores / float(L) ** cfg.length_penalty)
    all_scores = torch.cat([torch.where(state.finished_mask, state.finished_scores, NEG_INF), alive_final], dim=1)
    top, idx = _top_k(all_scores, W)
    sequences = _take(torch.cat([state.finished_tokens, state.alive_tokens], dim=1), idx)
    if cfg.return_components:
        comps = _take(torch.cat([state.finished_components, state.alive_components], dim=1), idx)
        return sequences, top, {"att": comps[..., 0], "ctc": comps[..., 1], "lm": comps[..., 2]}
    return sequences, top
