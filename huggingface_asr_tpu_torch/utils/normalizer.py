"""English text normalizer for scoring/eval (the port's own copy of
``huggingface_asr_tpu/utils/normalizer.py``, with its own copy of the
spelling map under ``huggingface_asr_tpu_torch/data/assets/``).

The reference ships a subclass of Whisper's EnglishTextNormalizer with extra
ASR-corpus handling (reference: src/utilities/english_normalizer.py:1751-1834):
hesitation collapsing, WSJ punctuation words, TED-LIUM ignore segments, and
bracket standardization for special tokens, plus a large British→American
spelling map. We build on the EnglishTextNormalizer that ships with
``transformers`` and add the same behavioral steps; the spelling map can be
supplied as a JSON file (it is corpus data, not code). ``transformers`` is
imported when a normalizer is made, not with this module.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

_HESITATIONS = r"\b(hmm|mm|mhm|huh|hum|oh|mmm|uh|um)\b"

_WSJ_PUNCT_WORDS = {
    ",comma": ",",
    ".period": ".",
    "?questionmark": "?",
    "!exclamationmark": "!",
    '"double-quote': '"',
    "-hyphen": "-",
    "...ellipsis": "...",
    "-dash": "-",
    "(left-paren": "(",
    ")right-paren": ")",
    ":colon": ":",
    ";semicolon": ";",
    "{left-brace": "{",
    "}right-brace": "}",
}


class EnglishNormalizer:
    """ASR-eval text normalizer preserving ([token])-style special markers."""

    def __init__(self, spelling_map: Optional[Dict[str, str]] = None,
                 spelling_json: Optional[str] = None):
        try:
            from transformers.models.whisper.english_normalizer import (
                EnglishTextNormalizer,
                remove_symbols_and_diacritics,
            )
        except ImportError as e:
            raise ImportError("transformers is required for EnglishNormalizer") from e
        self._remove_symbols = remove_symbols_and_diacritics
        if spelling_json is None and spelling_map is None:
            # Bundled British→American map (data/assets/english_spelling.json;
            # the public Whisper-normalizer spelling data the reference embeds
            # in english_normalizer.py:8-1749) — applied by default so scoring
            # matches the reference out of the box.
            spelling_json = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "data", "assets", "english_spelling.json",
            )
        if spelling_json:
            with open(spelling_json) as f:
                spelling_map = json.load(f)
        self._base = EnglishTextNormalizer(spelling_map or {})
        # Include "zero" in number-word handling (the upstream normalizer
        # omits it, which breaks sequences like "zero point five").
        nums = self._base.standardize_numbers
        nums.zeros = {"zero"}
        nums.decimals = {*nums.ones, *nums.tens, *nums.zeros}
        nums.words = nums.words | {"zero"}

    def __call__(self, text: str) -> str:
        s = text.lower()
        s = s.replace("ignore_time_segment_in_scoring", "")
        s = re.sub(_HESITATIONS, "[hesitation]", s)
        for key, value in _WSJ_PUNCT_WORDS.items():
            s = s.replace(key, value)
        s = re.sub(r"\s+'", "'", s)
        # standardize special-token brackets: [x], <x>, (%x), *x -> ([x])
        s = re.sub(r"\(?(\[|<|\(%|\*)(\w+)[]>)*]\)?", r"([\2])", s)
        s = re.sub(r"(\(\[hesitation\]\))(-\(\[hesitation\]\))+", "([hesitation])", s)
        for pattern, replacement in self._base.replacers.items():
            s = re.sub(pattern, replacement, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)
        s = self._remove_symbols(s, keep=".%$¢€£[]()-")
        s = re.sub(r"(\w)-(\w)", r"\1 \2", s)
        s = self._base.standardize_numbers(s)
        s = self._base.standardize_spellings(s)
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        s = re.sub(r"\s+", " ", s)
        return s.strip()
