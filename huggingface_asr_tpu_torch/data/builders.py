"""Dataset builders: Kaldi-style directories and VAD-segmented audio folders
(the port's own copy of ``huggingface_asr_tpu/data/builders.py``; numpy and
scipy only).

Equivalents of the reference's dataset_builders (reference:
src/dataset_builders/kaldi_dataset/kaldi_dataset.py:23-165,
audio_folder_vad/audio_folder_vad.py:28-100): host-side corpus ingestion that
materializes HF ``datasets`` with {audio array, text, input_len} rows.
Departures: WAV reading via scipy (no sox pipes), resampling via polyphase
scipy resample, and an energy-based VAD fallback when pyannote is absent.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _decode(rate: int, data: np.ndarray, target_rate: int) -> np.ndarray:
    """Integer or float WAV samples -> float32 mono at ``target_rate``."""
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if rate != target_rate:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(rate, target_rate)
        data = resample_poly(data, target_rate // g, rate // g).astype(np.float32)
    return data


def _read_piped_wav(command: str, target_rate: int) -> np.ndarray:
    """Run a Kaldi-style piped wav.scp command ("... |") and parse the WAV
    bytes from its stdout (reference kaldi_dataset.py:107-124)."""
    import io
    import subprocess

    from scipy.io import wavfile

    proc = subprocess.run(command.rstrip().rstrip("|"), shell=True, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, check=True)
    return _decode(*wavfile.read(io.BytesIO(proc.stdout)), target_rate)


def _read_wav(path: str, target_rate: int) -> Tuple[np.ndarray, int]:
    from scipy.io import wavfile

    return _decode(*wavfile.read(path), target_rate), target_rate


def _parse_kv_file(path: str) -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
            elif len(parts) == 1:
                out[parts[0]] = ""
    return out


def iter_kaldi_examples(
    data_dir: str, sampling_rate: int = 16000
) -> Iterator[Dict]:
    """Yield examples from a Kaldi data dir (wav.scp [+segments] + text)."""
    wav_scp = _parse_kv_file(os.path.join(data_dir, "wav.scp"))
    text = _parse_kv_file(os.path.join(data_dir, "text"))
    segments_path = os.path.join(data_dir, "segments")

    cache: Dict[str, np.ndarray] = {}

    def load(rec_id: str) -> np.ndarray:
        if rec_id not in cache:
            entry = wav_scp[rec_id]
            cache.clear()  # keep at most one recording resident
            if entry.rstrip().endswith("|"):
                # Piped command producing a WAV on stdout (Kaldi convention;
                # reference kaldi_dataset.py:107-124 reads these through a
                # shell pipe). Example: "sox foo.sph -t wav - |".
                cache[rec_id] = _read_piped_wav(entry, sampling_rate)
            else:
                cache[rec_id], _ = _read_wav(entry, sampling_rate)
        return cache[rec_id]

    if os.path.exists(segments_path):
        with open(segments_path) as f:
            for line in f:
                utt_id, rec_id, start, end = line.strip().split()
                if utt_id not in text:
                    continue
                audio = load(rec_id)
                s = int(float(start) * sampling_rate)
                e = int(float(end) * sampling_rate)
                segment = audio[s:e]
                yield {
                    "id": utt_id,
                    "audio": segment,
                    "text": text[utt_id],
                    "input_len": len(segment) / sampling_rate,
                }
    else:
        for utt_id, path in wav_scp.items():
            if utt_id not in text:
                continue
            audio = load(utt_id)
            yield {
                "id": utt_id,
                "audio": audio,
                "text": text[utt_id],
                "input_len": len(audio) / sampling_rate,
            }


def build_kaldi_dataset(data_dir: str, sampling_rate: int = 16000):
    """Materialize a Kaldi dir into an HF Dataset."""
    from datasets import Dataset

    return Dataset.from_generator(
        lambda: iter_kaldi_examples(data_dir, sampling_rate)
    )


def energy_vad(
    audio: np.ndarray,
    sampling_rate: int = 16000,
    frame_ms: float = 30.0,
    threshold_db: float = -35.0,
    min_speech_s: float = 0.3,
    max_silence_s: float = 0.3,
) -> List[Tuple[float, float]]:
    """Simple energy VAD: (start_s, end_s) speech segments."""
    frame = int(sampling_rate * frame_ms / 1000)
    n = len(audio) // frame
    if n == 0:
        return []
    frames = audio[: n * frame].reshape(n, frame)
    energy_db = 10 * np.log10(np.mean(frames**2, axis=1) + 1e-10)
    ref = np.max(energy_db)
    speech = energy_db > ref + threshold_db

    segments = []
    start = None
    silence = 0
    max_sil_frames = int(max_silence_s * 1000 / frame_ms)
    for i, s in enumerate(speech):
        if s:
            if start is None:
                start = i
            silence = 0
        elif start is not None:
            silence += 1
            if silence > max_sil_frames:
                segments.append((start, i - silence + 1))
                start, silence = None, 0
    if start is not None:
        segments.append((start, n))
    out = []
    for s, e in segments:
        dur = (e - s) * frame_ms / 1000
        if dur >= min_speech_s:
            out.append((s * frame_ms / 1000, e * frame_ms / 1000))
    return out


def iter_audio_folder_vad(
    folder: str,
    sampling_rate: int = 16000,
    use_pyannote: bool = False,
    max_segment_s: float = 30.0,
    vad_fn=None,
) -> Iterator[Dict]:
    """Walk a folder of wavs, VAD-segment, yield speech chunks with lengths.

    ``vad_fn(audio) -> [(start_s, end_s), ...]`` plugs in any external
    segmenter (e.g. a pyannote pipeline where installed); ``use_pyannote``
    tries the stock pyannote VAD with graceful fallback to energy VAD
    (reference: audio_folder_vad.py:39-61 requires pyannote
    unconditionally)."""
    if vad_fn is None and use_pyannote:
        try:
            from pyannote.audio import Pipeline  # noqa: F401

            pipeline = Pipeline.from_pretrained("pyannote/voice-activity-detection")

            def vad_fn(audio):
                import torch

                out = pipeline({"waveform": torch.tensor(audio)[None], "sample_rate": sampling_rate})
                return [(seg.start, seg.end) for seg in out.get_timeline()]

        except Exception as e:  # pragma: no cover
            logger.warning("pyannote unavailable (%s); using energy VAD", e)
    if vad_fn is None:
        vad_fn = lambda audio: energy_vad(audio, sampling_rate)

    for root, _, files in sorted(os.walk(folder)):
        for name in sorted(files):
            if not name.lower().endswith((".wav", ".wave")):
                continue
            path = os.path.join(root, name)
            audio, _ = _read_wav(path, sampling_rate)
            for i, (start, end) in enumerate(vad_fn(audio)):
                end = min(end, start + max_segment_s)
                s = int(start * sampling_rate)
                e = int(end * sampling_rate)
                segment = audio[s:e]
                yield {
                    "id": f"{os.path.splitext(name)[0]}_{i}",
                    "audio": segment,
                    "input_len": len(segment) / sampling_rate,
                }


def build_audio_folder_vad_dataset(folder: str, sampling_rate: int = 16000,
                                   use_pyannote: bool = False, vad_fn=None):
    from datasets import Dataset

    return Dataset.from_generator(
        lambda: iter_audio_folder_vad(folder, sampling_rate, use_pyannote,
                                      vad_fn=vad_fn)
    )
