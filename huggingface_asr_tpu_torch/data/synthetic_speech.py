"""Deterministic synthetic speech (the port's own copy of
``huggingface_asr_tpu/data/synthetic_speech.py``; numpy only, but for
``build_corpus``, which imports ``datasets`` to write its directory).

Renders text to 16 kHz audio where each character is a two-formant tone burst
with randomized duration, gain, and additive noise — an acoustically
learnable code that forces the full ASR pipeline (front end, subsampled
encoder, CTC/attention alignment, tokenizer, beam decode, WER scoring) to do
real work, while remaining reproducible with zero external data.

``utterance(seconds, rng)`` renders sampled sentences up to a wanted duration,
for smoke runs and tests that need speech-like input of a given length.
``corpus_rows`` makes the rows of the JAX package's ``build_corpus`` (what its
inner ``make`` does), so that a machine without ``datasets`` can build the
same corpus in memory; ``build_corpus`` saves them as a ``DatasetDict``.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
CHARS = "abcdefghijklmnopqrstuvwxyz"
_BASE_DUR = 0.12  # seconds per character

# ~2k words is enough to make the tokenizer/LM side non-trivial; keep common
# short words so utterances stay a few seconds long.
WORDS = (
    "the quick brown fox jumps over lazy dog speech model learns to map "
    "sound into text with high accuracy on this synthetic task we validate "
    "training decoding and scoring end to end before real corpora are used "
    "a small encoder can master these tone codes in few hundred steps"
).split()


def _char_freqs(idx: int, spacing: float = 1.0) -> tuple[float, float]:
    """Unique (f1, f2) formant pair per character. ``spacing < 1`` squeezes
    the grid so neighboring characters become acoustically confusable."""
    return (
        400.0 + 95.0 * spacing * (idx % 9),
        1500.0 + 240.0 * spacing * (idx // 9),
    )


def render_utterance(
    text: str,
    rng: np.random.Generator,
    noise: float = 0.02,
    *,
    freq_spacing: float = 1.0,
    speed_range: tuple[float, float] = (1.0, 1.0),
) -> np.ndarray:
    """Render text to a float32 waveform. Spaces become short near-silence.

    ``freq_spacing`` and ``speed_range`` are the hardening knobs (see
    the JAX package's ``build_corpus(hard=True)``): squeezed formants + per-utterance speed.
    """
    pieces = []
    gain = float(rng.uniform(0.5, 1.0))
    speed = float(rng.uniform(*speed_range))
    for ch in text:
        dur = _BASE_DUR / speed * float(rng.uniform(0.8, 1.25))
        n = max(int(dur * SAMPLE_RATE), 64)
        t = np.arange(n) / SAMPLE_RATE
        if ch == " ":
            seg = np.zeros(n, np.float32)
        else:
            f1, f2 = _char_freqs(CHARS.index(ch), freq_spacing)
            phase1, phase2 = rng.uniform(0, 2 * np.pi, 2)
            seg = 0.6 * np.sin(2 * np.pi * f1 * t + phase1) + 0.4 * np.sin(
                2 * np.pi * f2 * t + phase2
            )
            seg *= np.hanning(n)
        pieces.append(seg.astype(np.float32))
    wav = np.concatenate(pieces) * gain
    wav += rng.standard_normal(wav.shape).astype(np.float32) * noise
    return wav.astype(np.float32)


# Confusable-by-one-character word pairs for the hardened corpus: argmax
# near-ties between these make WER > 0 discriminative for parity (the two
# stacks must agree on the ERRORS, not just on clean transcripts).
CONFUSABLE_WORDS = (
    "fox fax box bog dog dig dug map mop cap cop code mode node note "
    "sound bound found text test best rest fast last list fist"
).split()


def sample_sentence(
    rng: np.random.Generator,
    min_words: int = 2,
    max_words: int = 5,
    vocab=None,
) -> str:
    n = int(rng.integers(min_words, max_words + 1))
    return " ".join(rng.choice(vocab if vocab is not None else WORDS, size=n))


def corpus_rows(
    n_train: int = 256,
    n_eval: int = 32,
    seed: int = 0,
    noise: float = 0.02,
    hard: bool = False,
):
    """The rows of ``build_corpus``: {"train", "validation", "test"} -> the
    columns {"audio": float32 waveforms, "text", "input_len": seconds}, drawn
    from one generator in that order (so a split's rows depend on the sizes of
    the splits before it). Eval splits use held-out sentences.

    ``hard=True`` produces a discriminative corpus: 6x the additive noise,
    squeezed formant spacing (confusable characters), per-utterance speed in
    [0.8, 1.3], and a vocabulary extended with minimal-pair words — trained
    models plateau at WER > 0, so transcript parity must agree on errors, not
    just on clean outputs.
    """
    rng = np.random.default_rng(seed)
    render_kw = {"noise": noise}
    vocab = None
    if hard:
        render_kw = {
            "noise": max(noise, 0.12),
            "freq_spacing": 0.45,
            "speed_range": (0.8, 1.3),
        }
        vocab = WORDS + CONFUSABLE_WORDS

    def make(n):
        rows = {"audio": [], "text": [], "input_len": []}
        for _ in range(n):
            text = sample_sentence(rng, vocab=vocab)
            wav = render_utterance(text, rng, **render_kw)
            rows["audio"].append(wav)
            rows["text"].append(text)
            rows["input_len"].append(len(wav) / SAMPLE_RATE)
        return rows

    return {"train": make(n_train), "validation": make(n_eval), "test": make(n_eval)}


def build_corpus(
    path: str,
    n_train: int = 256,
    n_eval: int = 32,
    seed: int = 0,
    noise: float = 0.02,
    hard: bool = False,
):
    """Build and save ``corpus_rows(...)`` as a DatasetDict in the corpus
    schema the CLIs consume (audio / text / input_len)."""
    import datasets

    dd = datasets.DatasetDict({
        split: datasets.Dataset.from_dict(rows)
        for split, rows in corpus_rows(n_train, n_eval, seed, noise, hard).items()
    })
    dd.save_to_disk(path)
    return dd


def utterance(seconds: float, rng: np.random.Generator, noise: float = 0.02):
    """(waveform, text): sentences sampled and rendered until the waveform
    reaches ``seconds``, then cut there; the text is cut to the characters
    that were rendered in full."""
    n = int(seconds * SAMPLE_RATE)
    waves, text, total = [], "", 0
    while total < n:
        sentence = sample_sentence(rng) + " "
        wav = render_utterance(sentence, rng, noise)
        if total + len(wav) > n:
            sentence = sentence[: max(int(len(sentence) * (n - total) / len(wav)) - 1, 0)]
        waves.append(wav)
        text += sentence
        total += len(wav)
    return np.concatenate(waves)[:n].astype(np.float32), " ".join(text.split())
