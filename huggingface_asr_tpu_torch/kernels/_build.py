"""Build, load and launch the CUDA kernels of ``csrc/``.

At the first kernel call, every ``csrc/*.cu`` file is compiled by ``nvcc``
for ``sm_90a`` (in parallel, one process per file) and linked into one shared
library under ``build/torch_kernels/`` in the checkout, named by a hash of
the sources, and loaded with ``ctypes``. The C functions take raw device
pointers, plain ints and floats, and the CUDA stream last; they return
``cudaGetLastError()`` after the launch. No PyTorch header is compiled, which
keeps a build at seconds.

Importing this module needs neither ``nvcc`` nor a GPU. A CUDA tensor that
reaches a kernel while ``nvcc`` is missing raises.

``LAUNCHES`` counts kernel launches by name; a wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, ctypes._CFuncPtr] = {}
build_seconds: Optional[float] = None


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library (cached by source hash).
    The compiler's output, register and spill counts included, goes to
    ``build.log`` beside the library."""
    global build_seconds
    so = BUILD_DIR / f"libasr_kernels_{_sources_hash()}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    # Per-process objects: two processes that build at once never link each
    # other's half-written files; the library itself lands by atomic rename.
    obj_dir = BUILD_DIR / f"obj_{so.stem}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, objs, failed = [], [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc={p.returncode})\n{out}")
        objs.append(str(obj))
        if p.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log)[-8000:])
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout[-8000:]}")
    os.replace(tmp, so)
    shutil.rmtree(obj_dir, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.asr_error_string.argtypes = [ctypes.c_int]
            lib.asr_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "u": ctypes.c_uint32, "f": ctypes.c_float}


def launch(name: str, spec: str, *args, label: Optional[str] = None) -> None:
    """Call C function ``name`` with ``args`` typed by ``spec`` (one letter
    per argument: p pointer, i int, u uint32, f float), the current stream appended.
    Raises if the launch reports an error; otherwise counts the launch under
    ``label`` (default ``name``)."""
    lib = library()
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[c] for c in spec] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    if len(args) != len(spec):
        raise TypeError(f"{name}: expected {len(spec)} arguments, got {len(args)}")
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: {lib.asr_error_string(rc).decode()}")
    LAUNCHES[label or name] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Optional[Sequence[int]] = None,
          contiguous: bool = True) -> None:
    """Raise unless ``t`` is a CUDA tensor of ``dtype`` (and ``shape``), contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when all are on the
    CPU; raises on a mix. The wrappers route CPU tensors to the plain version
    and CUDA tensors to the kernel."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")
