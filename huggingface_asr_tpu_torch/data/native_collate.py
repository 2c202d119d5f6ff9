"""ctypes bindings for the native batch assembler (counterpart of
``huggingface_asr_tpu/data/native_collate.py``).

The port keeps its own copy of the C++ source (``native/collate.cpp`` in
this package). At the first call it is compiled by ``g++`` into
``build/torch_native/`` in the checkout, named by a hash of the source, and
loaded with ``ctypes``; nothing is written beside the source. On a machine
with no ``g++`` on ``PATH`` the numpy fallback runs, with a warning; a
compile error with a compiler present raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent.parent / "native" / "collate.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> Path:
    """The library built from ``SOURCE`` (once per source hash)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libcollate_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}"
    proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builds leave one whole file
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if shutil.which("g++") is None:
            logger.warning("no g++ on PATH: the native collator is not built; numpy fallback")
            return None
        path = _compile()
        lib = ctypes.CDLL(str(path))
        lib.collate_f32.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.collate_i32.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pcm16_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        lib.pcm16_to_f32.restype = ctypes.c_int64
        _lib = lib
        logger.info("native collate library loaded from %s", path)
        return _lib


def using_native() -> bool:
    """Whether the calls run the compiled library (building it if needed)."""
    return _load() is not None


def _pointers(arrays: List[np.ndarray]):
    B = len(arrays)
    ptrs = (ctypes.c_void_p * B)(*[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays])
    lens = (ctypes.c_int64 * B)(*[len(a) for a in arrays])
    return ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), ctypes.cast(lens, ctypes.POINTER(ctypes.c_int64))


def _pad_numpy(arrays: List[np.ndarray], max_len: int, dtype, fill) -> Tuple[np.ndarray, np.ndarray]:
    out = np.full((len(arrays), max_len), fill, dtype)
    out_lens = np.empty((len(arrays),), np.int32)
    for i, r in enumerate(arrays):
        n = min(len(r), max_len)
        out[i, :n] = r[:n]
        out_lens[i] = n
    return out, out_lens


def collate_f32(rows: List[np.ndarray], max_len: int, num_threads: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (and cut) ragged float32 rows into a (B, max_len) batch + int32 lengths."""
    lib = _load()
    rows = [np.ascontiguousarray(r, dtype=np.float32) for r in rows]
    if lib is None:
        return _pad_numpy(rows, max_len, np.float32, 0.0)
    out = np.empty((len(rows), max_len), np.float32)
    out_lens = np.empty((len(rows),), np.int32)
    ptrs, lens = _pointers(rows)
    lib.collate_f32(ptrs, lens, len(rows), max_len, out.ctypes.data_as(ctypes.c_void_p),
                    out_lens.ctypes.data_as(ctypes.c_void_p), num_threads)
    return out, out_lens


def collate_i32(rows: List[List[int]], max_len: int, fill: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (and cut) ragged int rows into a (B, max_len) int32 batch filled
    with ``fill`` + int32 lengths."""
    lib = _load()
    arrs = [np.ascontiguousarray(r, dtype=np.int32) for r in rows]
    if lib is None:
        return _pad_numpy(arrs, max_len, np.int32, fill)
    out = np.empty((len(arrs), max_len), np.int32)
    out_lens = np.empty((len(arrs),), np.int32)
    ptrs, lens = _pointers(arrs)
    lib.collate_i32(ptrs, lens, len(arrs), max_len, fill, out.ctypes.data_as(ctypes.c_void_p),
                    out_lens.ctypes.data_as(ctypes.c_void_p))
    return out, out_lens


def pcm16_to_f32(pcm: np.ndarray, trim: bool = True) -> np.ndarray:
    """int16 PCM -> float32 waveform in [-1, 1), with the leading and
    trailing zero samples trimmed (reference data_utils.py:173-177)."""
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    lib = _load()
    if lib is None:
        x = np.trim_zeros(pcm) if trim else pcm
        return x.astype(np.float32) / 32768.0
    out = np.empty(len(pcm), np.float32)
    n = lib.pcm16_to_f32(pcm.ctypes.data_as(ctypes.c_void_p), len(pcm), out.ctypes.data_as(ctypes.c_void_p),
                         int(trim))
    return out[:n]
