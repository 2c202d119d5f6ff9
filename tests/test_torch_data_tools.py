"""The port's host-side data tools against the JAX package's: the native
collator (its own copy of ``native/collate.cpp``, built under
``build/torch_native/``), the Kaldi and VAD-folder builders and the
``preprocess_dataset`` CLI, on the same seeded inputs."""

import logging
import os

import numpy as np
import pytest

from huggingface_asr_tpu.cli.preprocess_dataset import main as j_preprocess
from huggingface_asr_tpu.data import builders as j_builders
from huggingface_asr_tpu.data import native_collate as j_native

from huggingface_asr_tpu_torch.cli.preprocess_dataset import main as p_preprocess
from huggingface_asr_tpu_torch.data import builders as p_builders
from huggingface_asr_tpu_torch.data import native_collate as p_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_wav(path, audio, rate=16000):
    from scipy.io import wavfile

    wavfile.write(str(path), rate, (np.clip(audio, -1, 1) * 32767).astype(np.int16))


# ---- the native collator


def test_collate_source_is_the_jax_packages():
    with open(os.path.join(REPO, "native", "collate.cpp"), "rb") as a, open(p_native.SOURCE, "rb") as b:
        assert a.read() == b.read()


def test_the_library_is_built_under_build_and_in_use():
    assert p_native.using_native()
    built = [n for n in os.listdir(p_native.BUILD_DIR) if n.startswith("libcollate_") and n.endswith(".so")]
    assert built and p_native.BUILD_DIR == p_native.SOURCE.parents[2] / "build" / "torch_native"


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for n in (300, 17, 0, 256, 1000)]


@pytest.mark.parametrize("max_len", [256, 1024])
def test_collate_f32_matches_jax(max_len):
    rows = _rows()
    for got, ref in zip(p_native.collate_f32(rows, max_len), j_native.collate_f32(rows, max_len)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fill", [0, -7])
def test_collate_i32_matches_jax(fill):
    rows = [[1, 2, 3], [], list(range(40)), [9]]
    for got, ref in zip(p_native.collate_i32(rows, 16, fill), j_native.collate_i32(rows, 16, fill)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("trim", [True, False])
def test_pcm16_to_f32_matches_jax(trim):
    pcm = np.random.default_rng(1).integers(-32768, 32767, 5000).astype(np.int16)
    pcm[:37] = 0
    pcm[-5:] = 0
    np.testing.assert_array_equal(p_native.pcm16_to_f32(pcm, trim), j_native.pcm16_to_f32(pcm, trim))


@pytest.fixture
def fresh_native(monkeypatch):
    """The module as before its first call."""
    monkeypatch.setattr(p_native, "_lib", None)
    monkeypatch.setattr(p_native, "_tried", False)
    return p_native


def test_without_gpp_the_numpy_fallback_runs_and_warns(fresh_native, monkeypatch, caplog):
    monkeypatch.setattr(fresh_native.shutil, "which", lambda name: None)
    rows = _rows(2)
    with caplog.at_level(logging.WARNING, logger=fresh_native.__name__):
        out = fresh_native.collate_f32(rows, 512)
        labels = fresh_native.collate_i32([[5, 6], [7]], 4, fill=3)
    assert not fresh_native.using_native()
    assert any("no g++" in r.message and r.levelno == logging.WARNING for r in caplog.records)
    for got, ref in zip(out + labels, j_native.collate_f32(rows, 512) + j_native.collate_i32([[5, 6], [7]], 4, 3)):
        np.testing.assert_array_equal(got, ref)


def test_a_compile_error_raises(fresh_native, monkeypatch, tmp_path):
    broken = tmp_path / "collate.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(fresh_native, "SOURCE", broken)
    monkeypatch.setattr(fresh_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        fresh_native.collate_f32(_rows(), 64)


# ---- the builders


@pytest.fixture(scope="module")
def kaldi_dir(tmp_path_factory):
    """Two recordings (one read through a piped wav.scp command, one at 8 kHz
    to resample), segments and text."""
    root = tmp_path_factory.mktemp("kaldi")
    rng = np.random.default_rng(0)
    _write_wav(root / "rec1.wav", 0.1 * rng.standard_normal(32000))
    _write_wav(root / "rec2.wav", 0.1 * rng.standard_normal(12000), rate=8000)
    (root / "wav.scp").write_text(f"rec1 {root}/rec1.wav\nrec2 cat {root}/rec2.wav |\n")
    (root / "segments").write_text("utt1 rec1 0.0 1.0\nutt2 rec1 1.0 1.9\nutt3 rec2 0.1 0.45\nutt4 rec2 0.5 1.0\n")
    (root / "text").write_text("utt1 hello world\nutt2 test case\nutt3 more text\n")  # utt4 has no text
    flat = tmp_path_factory.mktemp("kaldi_flat")
    _write_wav(flat / "a.wav", 0.1 * rng.standard_normal(4000))
    (flat / "wav.scp").write_text(f"a {flat}/a.wav\nb cat {root}/rec2.wav |\n")
    (flat / "text").write_text("a some words\nb piped words\n")
    return {"segments": str(root), "no_segments": str(flat)}


def _assert_same_examples(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            if k == "audio":
                np.testing.assert_array_equal(g[k], r[k])
            else:
                assert g[k] == r[k], k


@pytest.mark.parametrize("layout", ["segments", "no_segments"])
def test_iter_kaldi_examples_matches_jax(kaldi_dir, layout):
    got = list(p_builders.iter_kaldi_examples(kaldi_dir[layout]))
    ref = list(j_builders.iter_kaldi_examples(kaldi_dir[layout]))
    _assert_same_examples(got, ref)
    if layout == "segments":
        assert [e["id"] for e in got] == ["utt1", "utt2", "utt3"]


def _speechy(seed, seconds=4.0, rate=16000):
    """Bursts of noise between silences."""
    rng = np.random.default_rng(seed)
    audio = 1e-4 * rng.standard_normal(int(seconds * rate))
    for start, dur in ((0.3, 0.8), (1.5, 0.2), (2.0, 1.1), (3.4, 0.35)):
        burst = audio[int(start * rate):int((start + dur) * rate)]
        burst += 0.3 * rng.standard_normal(len(burst))
    return audio.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_energy_vad_matches_jax(seed):
    audio = _speechy(seed)
    got = p_builders.energy_vad(audio)
    assert got == j_builders.energy_vad(audio) and len(got) >= 2
    kw = dict(threshold_db=-20.0, min_speech_s=0.5, max_silence_s=0.1)
    assert p_builders.energy_vad(audio, **kw) == j_builders.energy_vad(audio, **kw)


@pytest.fixture(scope="module")
def vad_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("vad")
    (root / "sub").mkdir()
    _write_wav(root / "b.wav", _speechy(2))
    _write_wav(root / "sub" / "a.WAV", _speechy(3, seconds=3.0))
    (root / "notes.txt").write_text("not audio")
    return str(root)


def test_iter_audio_folder_vad_matches_jax(vad_folder):
    _assert_same_examples(list(p_builders.iter_audio_folder_vad(vad_folder, max_segment_s=0.5)),
                          list(j_builders.iter_audio_folder_vad(vad_folder, max_segment_s=0.5)))


def test_iter_audio_folder_vad_with_pyannote_falls_back_to_energy_vad(vad_folder, monkeypatch):
    """Where pyannote cannot be imported (made so here: its pipeline would be
    fetched from the hub) both packages warn and use the energy VAD."""
    import sys

    monkeypatch.setitem(sys.modules, "pyannote", None)
    monkeypatch.setitem(sys.modules, "pyannote.audio", None)
    _assert_same_examples(list(p_builders.iter_audio_folder_vad(vad_folder, use_pyannote=True)),
                          list(j_builders.iter_audio_folder_vad(vad_folder)))


@pytest.mark.parametrize("builder", ["kaldi", "audio_folder_vad"])
def test_preprocess_dataset_writes_equal_rows(kaldi_dir, vad_folder, builder, tmp_path, monkeypatch):
    import datasets

    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", str(tmp_path / "hf_cache"))
    source = kaldi_dir["segments"] if builder == "kaldi" else vad_folder
    outs = {}
    for name, main in (("jax", j_preprocess), ("port", p_preprocess)):
        outs[name] = str(tmp_path / name)
        main(["--builder", builder, "--source_dir", source, "--output_dir", outs[name]])
    got, ref = datasets.load_from_disk(outs["port"]), datasets.load_from_disk(outs["jax"])
    assert got.column_names == ref.column_names and len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        for k in r:
            if k == "audio":
                np.testing.assert_array_equal(np.asarray(g[k], np.float32), np.asarray(r[k], np.float32))
            else:
                assert g[k] == r[k], k
