"""Batched CTC prefix scoring for joint CTC/attention decoding
(counterpart of ``huggingface_asr_tpu/decoding/ctc_prefix.py``).

The vectorized hybrid CTC/attention prefix score (Watanabe et al., Alg. 2;
Seki et al. 2019) over a per-beam candidate set: the forward tensor is
(T, 2, BW, K), not (T, 2, BW, V). Frames past each utterance's length get
log-prob 0 for blank and ``LOG_ZERO`` elsewhere, so every shape is static.

State layout: r (T, 2, BW) forward log-probs of the current prefix (n: ends
in a non-blank, b: ends in blank), s (BW,) prefix score, last (BW,) last token,
length (BW,) tokens after the start.

Streaming: ``extended`` appends a chunk of posteriors, ``extend_state``
continues a state into it (a cheap approximation) and ``replay_state``
rebuilds a state over all frames exactly.

Plain PyTorch on every device: the JAX function holds no Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

LOG_ZERO = -1.0e10


def _lse2(a, b):
    # the 1e-38 guard: deep semiring products push both arguments far below
    # LOG_ZERO, where log(0) would make a true -inf and NaN downstream
    m = torch.clamp(torch.maximum(a, b), min=LOG_ZERO)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + 1e-38)


def _lse3(a, b, c):
    m = torch.clamp(torch.maximum(torch.maximum(a, b), c), min=LOG_ZERO)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m) + 1e-38)


def _lse2_unguarded(a, b):
    m = torch.clamp(torch.maximum(a, b), min=LOG_ZERO)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def _combine(x, y):
    """Compose two affine maps of the log semiring, ``y`` after ``x``; each is
    the 5 free entries (A, C, D, E, F) of [[A, -inf, C], [D, E, F], [-inf, -inf, 0]]."""
    XA, XC, XD, XE, XF = x
    YA, YC, YD, YE, YF = y
    return (
        YA + XA,
        _lse2(YA + XC, YC),
        _lse2(YD + XA, YE + XD),
        YE + XE,
        _lse3(YD + XC, YE + XF, YF),
    )


def _forward_assoc(r0_n, r0_b, xk, xb, phi):
    """The CTC forward recursion as an inclusive scan of semiring maps.

    Per frame t (1-indexed relative to the r0 state):
        rn[t] = lse(rn[t-1], phi[t-1]) + xk[t]
        rb[t] = lse(rn[t-1], rb[t-1]) + xb[t]
    is u_t = M_t (x) u_{t-1} with u = [rn, rb, 0]. The prefix products are
    evaluated by recursive doubling (ceil(log2 T) levels, each one batched
    composition over all frames), the same O(log T) depth as the JAX
    ``associative_scan``. Returns (rn_seq, rb_seq), each (T-1, BW, K)."""
    xbb = xb[:, :, None].expand_as(xk)
    elems = (xk, phi + xk, xbb, xbb, torch.full_like(xk, LOG_ZERO))
    n, d = xk.shape[0], 1
    while d < n:
        earlier = tuple(e[:-d] for e in elems)
        later = tuple(e[d:] for e in elems)
        elems = tuple(torch.cat([e[:d], c], dim=0) for e, c in zip(elems, _combine(earlier, later)))
        d *= 2
    PA, PC, PD, PE, PF = elems
    rn_seq = _lse2(PA + r0_n[None], PC)
    rb_seq = _lse3(PD + r0_n[None], PE + r0_b[None], PF)
    return rn_seq, rb_seq


class CTCPrefixState(NamedTuple):
    r: torch.Tensor  # (T, 2, BW) forward log-probs of the current prefixes
    s: torch.Tensor  # (BW,) prefix scores log P_ctc(prefix)
    last: torch.Tensor  # (BW,) last emitted token id
    length: torch.Tensor  # (BW,) prefix length (tokens after the start)


class CTCPrefixScorer:
    """Holds the prepared CTC log-posteriors; the step methods return new states.

    ``impl``: ``"assoc"`` (default), the semiring scan of O(log T) depth;
    ``"scan"``, the sequential recursion over frames."""

    def __init__(self, ctc_log_probs: torch.Tensor, lengths: torch.Tensor, blank_id: int, eos_id: int,
                 impl: str = "assoc"):
        if impl not in ("assoc", "scan"):
            raise ValueError(f"impl={impl!r}: 'assoc' or 'scan'")
        self.impl = impl
        B, T, V = ctc_log_probs.shape
        self.batch, self.input_length, self.odim = B, T, V
        self.blank_id, self.eos_id = blank_id, eos_id
        lp = ctc_log_probs.float()
        valid = torch.arange(T, device=lp.device)[None, :] < lengths.to(lp.device)[:, None]  # (B, T)
        x = torch.where(valid[..., None], lp, LOG_ZERO)
        blank_col = torch.where(valid, lp[..., blank_id], 0.0)
        x[..., blank_id] = blank_col
        self.xn = x.permute(1, 0, 2).contiguous()  # (T, B, V) token log-probs
        self.xb = blank_col.t().contiguous()  # (T, B) blank log-probs

    def init_state(self, num_hyps: int) -> CTCPrefixState:
        """State for BW = batch * num_hyps empty prefixes."""
        B, T = self.batch, self.input_length
        BW, dev = B * num_hyps, self.xb.device
        r = torch.full((T, 2, BW), LOG_ZERO, dtype=torch.float32, device=dev)
        # the empty prefix survives through blanks
        r[:, 1, :] = torch.cumsum(self.xb, dim=0).repeat_interleave(num_hyps, dim=1)
        return CTCPrefixState(
            r=r,
            s=torch.zeros(BW, dtype=torch.float32, device=dev),
            last=torch.full((BW,), -1, dtype=torch.int64, device=dev),
            length=torch.zeros(BW, dtype=torch.int64, device=dev),
        )

    def score_candidates(self, state: CTCPrefixState, candidate_ids: torch.Tensor
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Score extending each prefix by each candidate token.

        candidate_ids: (BW, K). Returns (token scores (BW, K) = log psi - s_prev,
        (r_new (T, 2, BW, K), log psi (BW, K)))."""
        T, B, V = self.input_length, self.batch, self.odim
        BW, K = candidate_ids.shape
        dev = candidate_ids.device
        batch_of = torch.arange(B, device=dev).repeat_interleave(BW // B)  # (BW,)
        # one gather on flattened (batch, vocab) indices: (T, BW, K)
        flat_idx = (batch_of[:, None] * V + candidate_ids).reshape(-1)
        xk = self.xn.reshape(T, B * V)[:, flat_idx].reshape(T, BW, K)
        xb_bh = self.xb[:, batch_of]  # (T, BW)

        # log_phi[t, i, k]: the prefix's probability at frame t that lets the
        # candidate start at t+1; a repeat of the last token extends only
        # blank-ending paths
        r_sum = torch.logsumexp(state.r, dim=1)  # (T, BW)
        is_repeat = candidate_ids == state.last[:, None]
        log_phi = torch.where(is_repeat[None], state.r[:, 1, :, None], r_sum[:, :, None])  # (T, BW, K)

        # frame 0: a candidate is emitted there only after the empty prefix
        empty = (state.length == 0)[:, None]
        r0_n = torch.where(empty, xk[0], LOG_ZERO)
        r0_b = torch.full_like(r0_n, LOG_ZERO)

        if self.impl == "assoc":
            rn_seq, rb_seq = _forward_assoc(r0_n, r0_b, xk[1:], xb_bh[1:], log_phi[:-1])
            grow = log_phi[:-1] + xk[1:]
            psi = _lse2_unguarded(torch.logsumexp(torch.clamp(grow, min=LOG_ZERO), dim=0), r0_n)
        else:
            rn, rb, psi = r0_n, r0_b, r0_n  # psi starts with the frame-0 emission
            rn_list, rb_list = [], []
            for t in range(1, T):
                xk_t, phi_prev = xk[t], log_phi[t - 1]
                grow = phi_prev + xk_t  # the candidate emitted at frame t
                rn, rb = _lse2_unguarded(rn, phi_prev) + xk_t, _lse2_unguarded(rn, rb) + xb_bh[t][:, None]
                psi = _lse2_unguarded(psi, grow)
                rn_list.append(rn)
                rb_list.append(rb)
            empty_seq = r0_n.new_empty((0,) + r0_n.shape)
            rn_seq = torch.stack(rn_list) if rn_list else empty_seq
            rb_seq = torch.stack(rb_list) if rb_list else empty_seq
        r_new = torch.stack([torch.cat([r0_n[None], rn_seq]), torch.cat([r0_b[None], rb_seq])], dim=1)

        # blank never extends a prefix as a label
        log_psi = torch.where(candidate_ids == self.blank_id, LOG_ZERO, psi)
        return log_psi - state.s[:, None], (r_new, log_psi)

    def extended(self, ctc_log_probs: torch.Tensor, lengths: torch.Tensor) -> "CTCPrefixScorer":
        """Streaming: a scorer over the old frames and a new chunk of
        posteriors (the reference's ``extend_prob``). The prepared tensors
        concatenate exactly: frames past each chunk's length are blank 0 and
        ``LOG_ZERO`` elsewhere, the padding the reference inserts mid-stream."""
        new = CTCPrefixScorer(ctc_log_probs, lengths, self.blank_id, self.eos_id, impl=self.impl)
        if new.batch != self.batch or new.odim != self.odim:
            raise ValueError(f"extended: chunk of batch {new.batch} and {new.odim} outputs, scorer of "
                             f"{self.batch} and {self.odim}")
        merged = CTCPrefixScorer.__new__(CTCPrefixScorer)
        merged.impl = self.impl
        merged.batch, merged.odim = self.batch, self.odim
        merged.blank_id, merged.eos_id = self.blank_id, self.eos_id
        merged.input_length = self.input_length + new.input_length
        merged.xn = torch.cat([self.xn, new.xn], dim=0)
        merged.xb = torch.cat([self.xb, new.xb], dim=0)
        return merged

    def extend_state(self, state: CTCPrefixState, old_T: int) -> CTCPrefixState:
        """Continue a state's forward variables into this scorer's frames past
        ``old_T``, the documented cheap approximation (O(T_new)):

            rn[t] = rn[t-1] + x_t[last]   (re-emission collapses repeats)
            rb[t] = lse(rn[t-1], rb[t-1]) + x_t[blank]

        It keeps more probability mass than the reference's blank-only
        ``extend_state`` but still drops the paths whose last label is first
        emitted inside the new frames; ``replay_state`` is the exact
        continuation."""
        BW = state.r.shape[2]
        batch_of = torch.arange(self.batch, device=state.r.device).repeat_interleave(BW // self.batch)
        xb_new = self.xb[old_T:, batch_of]  # (T_new, BW)
        safe_last = torch.clamp(state.last, 0, self.odim - 1)
        x_last = self.xn[old_T:, batch_of, safe_last]  # (T_new, BW)
        x_last = torch.where(state.last[None, :] >= 0, x_last, LOG_ZERO)
        rn, rb = state.r[old_T - 1, 0], state.r[old_T - 1, 1]
        ext = []
        for t in range(x_last.shape[0]):
            rn, rb = rn + x_last[t], _lse2(rn, rb) + xb_new[t]
            ext.append(torch.stack([rn, rb]))
        r_ext = torch.stack(ext) if ext else state.r.new_empty((0,) + state.r.shape[1:])
        return CTCPrefixState(r=torch.cat([state.r, r_ext], dim=0), s=state.s, last=state.last,
                              length=state.length)

    def replay_state(self, tokens: torch.Tensor, lengths: torch.Tensor, num_hyps: int) -> CTCPrefixState:
        """The exact streaming state: every prefix's forward variables over all
        frames of this (extended) scorer, rebuilt by replaying its tokens.
        tokens (BW, L), anything past each prefix's ``lengths`` (BW,). O(L T)."""
        state = self.init_state(num_hyps)
        BW, L = tokens.shape
        beam_idx = torch.arange(BW, device=tokens.device)
        zeros = torch.zeros(BW, dtype=torch.int64, device=tokens.device)
        for step in range(L):
            tok = tokens[:, step]
            _, scored = self.score_candidates(state, tok[:, None])
            new = self.select_state(state, scored, beam_idx, zeros, tok)
            alive = step < lengths.to(tokens.device)
            state = CTCPrefixState(
                r=torch.where(alive[None, None, :], new.r, state.r),
                s=torch.where(alive, new.s, state.s),
                last=torch.where(alive, new.last, state.last),
                length=torch.where(alive, new.length, state.length),
            )
        return state

    def select_state(self, state: CTCPrefixState, scored: Tuple[torch.Tensor, torch.Tensor],
                     beam_idx: torch.Tensor, cand_idx: torch.Tensor, new_tokens: torch.Tensor
                     ) -> CTCPrefixState:
        """Reorder and advance the state after beam selection: ``beam_idx`` (BW,)
        indexes the previous hypotheses, ``cand_idx`` (BW,) the K candidates of
        that hypothesis, ``new_tokens`` (BW,) the chosen ids."""
        r_new, log_psi = scored
        return CTCPrefixState(
            r=r_new[:, :, beam_idx, cand_idx],  # (T, 2, BW)
            s=log_psi[beam_idx, cand_idx],
            last=new_tokens.to(torch.int64),
            length=state.length[beam_idx] + 1,
        )
