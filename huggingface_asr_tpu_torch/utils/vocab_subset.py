"""LLM vocabulary-subset extraction for CTC-over-LLM heads (the port's own
copy of ``huggingface_asr_tpu/utils/vocab_subset.py``; numpy only).

Behavioral twin of the reference's ``get_token_subset``
(recipes_v0.0.1/librispeech_whisper_ctc/local_utils.py:95-113): keep only
tokens whose decoded text is lowercase-English charset (plus specials),
producing old↔new id mappings. Used to shrink an LLM lm-head to the usable
subset before CTC training (huge softmax → small softmax), and to map
predictions back for detokenization.
"""

from __future__ import annotations

import string
from typing import Dict, List, Tuple

import numpy as np

_CHARSET = set(string.digits + string.ascii_lowercase + string.punctuation + " ")


def get_token_subset(
    tokenizer,
) -> Tuple[Dict[int, int], Dict[int, int], List[int]]:
    """Returns (old→new mapping, new→old mapping, removed old ids)."""
    specials = set(tokenizer.all_special_tokens)
    mapping: Dict[int, int] = {}
    removed: List[int] = []
    for i in range(len(tokenizer)):
        token = tokenizer.decode(i)
        if all(c in _CHARSET for c in token) or token in specials:
            mapping[i] = len(mapping)
        else:
            removed.append(i)
    inverted = {v: k for k, v in mapping.items()}
    return mapping, inverted, removed


def subset_lm_head(kernel: np.ndarray, mapping: Dict[int, int]) -> np.ndarray:
    """Shrink an (hidden, V_old) lm-head kernel to (hidden, V_new) columns in
    new-id order."""
    old_ids = [old for old, _ in sorted(mapping.items(), key=lambda kv: kv[1])]
    return np.ascontiguousarray(np.asarray(kernel)[:, old_ids])


def map_ids(ids, mapping: Dict[int, int]) -> List[int]:
    """Map a sequence of ids through a mapping, dropping unmapped ids."""
    return [mapping[int(i)] for i in ids if int(i) in mapping]
