"""Deterministic synthetic speech (the port's own copy of
``huggingface_asr_tpu/data/synthetic_speech.py``, numpy only; ``build_corpus``,
which writes an HF ``datasets`` directory, is not carried over).

Renders text to 16 kHz audio where each character is a two-formant tone burst
with randomized duration, gain, and additive noise — an acoustically
learnable code that forces the full ASR pipeline (front end, subsampled
encoder, CTC/attention alignment, tokenizer, beam decode, WER scoring) to do
real work, while remaining reproducible with zero external data.

``utterance(seconds, rng)`` renders sampled sentences up to a wanted duration,
for smoke runs and tests that need speech-like input of a given length.
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
