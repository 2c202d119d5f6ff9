"""Evaluation & n-best dumping (the port's own copy of
``huggingface_asr_tpu/utils/eval_utils.py``).

Mirrors the reference's do_evaluate/do_generate stack (reference:
src/utilities/general_utils.py:129-228, eval_utils.py:65-99,
generation_utils.py:16-93): per-test-split decoding, WER/CER suite,
wall-time + tokens/s throughput logging, CSV + sclite ``.trn`` outputs, and
n-best hypothesis/score dumping for rescoring experiments.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from huggingface_asr_tpu_torch.utils.metrics import cer, wer

logger = logging.getLogger(__name__)


def get_metrics(refs: List[str], hyps: List[str]) -> Dict[str, float]:
    """jiwer-equivalent suite (reference eval_utils.py:29-34)."""
    w = wer(refs, hyps, detailed=True)
    return {
        "wer": w["rate"],
        "cer": cer(refs, hyps),
        "mer": w["mer"],
        "wil": w["wil"],
        "del": w["deletions"],
        "ins": w["insertions"],
        "sub": w["substitutions"],
    }


def save_predictions(
    refs: List[str], hyps: List[str], ids: List[str], path_prefix: str
):
    """CSV + sclite trn files (reference generation_utils.py:55-93)."""
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with open(path_prefix + ".csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["id", "label", "prediction"])
        for i, r, h in zip(ids, refs, hyps):
            writer.writerow([i, r, h])
    with open(path_prefix + "_ref.trn", "w") as f:
        for i, r in zip(ids, refs):
            f.write(f"{r} ({i})\n")
    with open(path_prefix + "_hyp.trn", "w") as f:
        for i, h in zip(ids, hyps):
            f.write(f"{h} ({i})\n")


def try_sclite(path_prefix: str) -> Optional[str]:
    """Side-score with sclite when the binary exists (reference
    training_utils.py:152-158)."""
    import shutil
    import subprocess

    if shutil.which("sclite") is None:
        return None
    out = subprocess.run(
        ["sclite", "-F", "-D", "-i", "wsj",
         "-r", path_prefix + "_ref.trn", "trn",
         "-h", path_prefix + "_hyp.trn", "trn",
         "-o", "snt", "sum"],
        capture_output=True, text=True,
    )
    return out.stdout


@dataclasses.dataclass
class SplitResult:
    metrics: Dict[str, float]
    wall_time: float
    tokens_per_sec: float
    num_examples: int


def evaluate_splits(
    decode_batch: Callable[[Dict[str, np.ndarray]], Tuple[List[str], List[List[str]]]],
    splits: Dict[str, Iterable[Dict[str, np.ndarray]]],
    references: Dict[str, List[str]],
    output_dir: Optional[str] = None,
    normalizer: Optional[Callable[[str], str]] = None,
) -> Dict[str, SplitResult]:
    """Decode every test split and score it.

    decode_batch: batch dict -> (best hypotheses, optional n-best lists).
    references: split -> reference transcripts aligned with batch order.
    """
    results = {}
    for split, batches in splits.items():
        hyps: List[str] = []
        t0 = time.time()
        for batch in batches:
            num_real = int(batch.pop("_num_real", -1))
            best, _ = decode_batch(batch)
            if num_real >= 0:
                best = best[:num_real]
            hyps.extend(best)
        wall = time.time() - t0
        refs = references[split]
        if len(refs) != len(hyps):
            raise ValueError(
                f"split {split}: {len(refs)} references vs {len(hyps)} "
                "hypotheses — eval batches and references are misaligned"
            )
        if normalizer is not None:
            refs = [normalizer(r) for r in refs]
            hyps = [normalizer(h) for h in hyps]
        metrics = get_metrics(refs, hyps)
        n_tokens = sum(len(h.split()) for h in hyps)
        result = SplitResult(
            metrics=metrics,
            wall_time=wall,
            tokens_per_sec=n_tokens / max(wall, 1e-9),
            num_examples=len(hyps),
        )
        logger.info(
            "split %s: WER %.2f%% (%d ex, %.1fs, %.1f tok/s)",
            split, 100 * metrics["wer"], len(hyps), wall, result.tokens_per_sec,
        )
        if output_dir:
            prefix = os.path.join(output_dir, f"predictions_{split}")
            ids = [f"utt_{i}" for i in range(len(hyps))]
            save_predictions(refs, hyps, ids, prefix)
            with open(os.path.join(output_dir, f"metrics_{split}.json"), "w") as f:
                json.dump({**metrics, "wall_time": wall,
                           "tokens_per_sec": result.tokens_per_sec}, f, indent=2)
            try_sclite(prefix)
        results[split] = result
    return results


def save_nbests(
    path_prefix: str,
    sequences: np.ndarray,  # (N, W, L) token ids
    scores: np.ndarray,  # (N, W)
    detokenize: Callable[[List[int]], str],
    ids: Optional[List[str]] = None,
    batch_size: int = 1,
):
    """Dump n-best hypotheses + scores (reference generation_utils.py:16-52)."""
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    N, W, L = sequences.shape
    ids = ids or [f"utt_{i}" for i in range(N)]
    with open(path_prefix + "_hyps.txt", "w") as fh, open(
        path_prefix + "_scores.txt", "w"
    ) as fs:
        for i in range(N):
            for w in range(W):
                toks = [int(t) for t in sequences[i, w]]
                fh.write(f"{ids[i]}-{w} {detokenize(toks)}\n")
                fs.write(f"{ids[i]}-{w} {float(scores[i, w]):.6f}\n")
