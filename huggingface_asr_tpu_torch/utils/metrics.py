"""WER / CER metrics (jiwer-equivalent, dependency-free; the port's own copy
of ``huggingface_asr_tpu/utils/metrics.py``).

The reference computes WER/CER/MER/WIL via jiwer (reference:
src/utilities/eval_utils.py:29-34). We implement Levenshtein alignment
directly (numpy DP) to avoid the dependency; values match jiwer's
``wer``/``cer`` definitions: total edits / total reference tokens over the
corpus (not averaged per utterance).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int]:
    """Return (substitutions, deletions, insertions) of the minimal alignment."""
    m, n = len(ref), len(hyp)
    # dp cell: (cost, subs, dels, ins) for ref[:i] -> hyp[:j]
    prev = [(j, 0, 0, j) for j in range(n + 1)]
    for i in range(1, m + 1):
        cur = [(i, 0, i, 0)]
        for j in range(1, n + 1):
            mismatch = ref[i - 1] != hyp[j - 1]
            sub_c = prev[j - 1][0] + mismatch
            del_c = prev[j][0] + 1
            ins_c = cur[j - 1][0] + 1
            best = min(sub_c, del_c, ins_c)
            if best == sub_c:
                _, s, d, ins = prev[j - 1]
                cur.append((best, s + mismatch, d, ins))
            elif best == del_c:
                _, s, d, ins = prev[j]
                cur.append((best, s, d + 1, ins))
            else:
                _, s, d, ins = cur[j - 1]
                cur.append((best, s, d, ins + 1))
        prev = cur
    _, s, d, ins = prev[n]
    return s, d, ins


def _corpus_rate(refs: List[Sequence], hyps: List[Sequence]) -> Dict[str, float]:
    total_s = total_d = total_i = total_ref = 0
    for r, h in zip(refs, hyps):
        s, d, i = edit_distance(r, h)
        total_s += s
        total_d += d
        total_i += i
        total_ref += len(r)
    total_ref = max(total_ref, 1)
    hits = total_ref - total_s - total_d
    total_hyp = max(sum(len(h) for h in hyps), 1)
    return {
        "rate": (total_s + total_d + total_i) / total_ref,
        "substitutions": total_s,
        "deletions": total_d,
        "insertions": total_i,
        "hits": hits,
        "mer": (total_s + total_d + total_i)
        / max(total_s + total_d + total_i + hits, 1),
        "wil": 1.0 - (hits / total_ref) * (hits / total_hyp),
    }


def wer(references: List[str], hypotheses: List[str], detailed: bool = False):
    """Corpus word error rate (jiwer-compatible)."""
    refs = [r.split() for r in references]
    hyps = [h.split() for h in hypotheses]
    stats = _corpus_rate(refs, hyps)
    return stats if detailed else stats["rate"]


def cer(references: List[str], hypotheses: List[str], detailed: bool = False):
    """Corpus character error rate (jiwer-compatible: whitespace kept as chars
    after collapsing runs)."""
    refs = [list(" ".join(r.split())) for r in references]
    hyps = [list(" ".join(h.split())) for h in hypotheses]
    stats = _corpus_rate(refs, hyps)
    return stats if detailed else stats["rate"]
