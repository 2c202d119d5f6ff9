"""Text transform registry for the config-driven corpus pipeline (the port's
own copy of ``huggingface_asr_tpu/data/text_transforms.py``).

The reference looks transforms up by name via ``globals()`` from JSON corpus
configs (reference: src/utilities/data_utils.py:110-163,339,351). We keep the
same names and semantics but use an explicit registry, with ``*_train``
suffix handling (train-split-only transforms) done by the caller.

Transforms: str -> str. Filters: str -> bool (True = keep).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List

TEXT_TRANSFORMS: Dict[str, Callable[[str], str]] = {}
TEXT_FILTERS: Dict[str, Callable[[str], bool]] = {}


def transform(fn):
    TEXT_TRANSFORMS[fn.__name__] = fn
    return fn


def text_filter(fn):
    TEXT_FILTERS[fn.__name__] = fn
    return fn


_PUNCTUATION = re.compile(r"[!\"#$%&'()*+,./\\:;<=>?@^_`{|}~]")
_MULTISPACE = re.compile(r"\s+")
_ESCAPED_TOKENS = re.compile(r"\(\S+\)")
_UNFINISHED = re.compile(r"\(?\w+-\)?")

_TEDLIUM_CONTRACTIONS = [" 's", " 't", " 're", " 've", " 'm", " 'll", " 'd", " 'clock", " 'all"]

GIGASPEECH_TOKEN_MAP = {
    "<COMMA>": ",",
    "<PERIOD>": ".",
    "<QUESTIONMARK>": "?",
    "<EXCLAMATIONMARK>": "!",
}


@transform
def do_lower_case(text: str) -> str:
    return text.lower()


@transform
def remove_punctuation(text: str) -> str:
    return _PUNCTUATION.sub("", text)


@transform
def remove_multiple_whitespaces_and_strip(text: str) -> str:
    return _MULTISPACE.sub(" ", text).strip()


@transform
def clean_special_tokens_english(text: str) -> str:
    return _ESCAPED_TOKENS.sub("", text)


@transform
def transforms_unfinished_words_to_unks(text: str) -> str:
    return _UNFINISHED.sub("([unk])", text)


@transform
def fix_tedlium_apostrophes(text: str) -> str:
    for contraction in _TEDLIUM_CONTRACTIONS:
        text = text.replace(contraction, contraction[1:])
    return text.replace(r"\s+ '", r" '")


@transform
def map_gigaspeech_spec_tokens(text: str) -> str:
    for token, replacement in GIGASPEECH_TOKEN_MAP.items():
        text = text.replace(token, replacement)
    return text


@transform
def whisper_normalize_english(text: str) -> str:
    from huggingface_asr_tpu_torch.utils.normalizer import EnglishNormalizer

    return EnglishNormalizer()(text)


@text_filter
def filter_empty_transcriptions(text: str) -> bool:
    return text != ""


@text_filter
def filter_tedlium_empty_labels(text: str) -> bool:
    return text != "ignore_time_segment_in_scoring"


def apply_text_transforms(
    text: str, names: List[str], is_train_split: bool
) -> tuple[str, bool]:
    """Apply a JSON-config list of transform/filter names to one string.

    Names ending in ``_train`` only run on train splits (reference
    data_utils.py:337-349). Returns (text, keep).
    """
    keep = True
    for raw in names:
        name = raw
        if name.endswith("_train"):
            if not is_train_split:
                continue
            name = name[: -len("_train")]
        if name in TEXT_TRANSFORMS:
            text = TEXT_TRANSFORMS[name](text)
        elif name in TEXT_FILTERS:
            keep = keep and TEXT_FILTERS[name](text)
        else:
            raise KeyError(f"unknown text transform '{raw}'")
    return text, keep
