"""Background batch prefetching (counterpart of
``huggingface_asr_tpu/data/prefetch.py``).

A thread keeps a bounded queue of ready batches ahead of the training step,
optionally already on their way to the device: ``pinned_device_put`` stages a
batch in pinned host memory and starts a ``non_blocking`` copy, so the
transfer overlaps the previous step.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch


class PrefetchIterator:
    """Wrap a batch iterator with an N-deep background prefetch queue."""

    _SENTINEL = object()

    def __init__(
        self,
        source: Iterable[Dict[str, np.ndarray]],
        depth: int = 2,
        device_put: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None,
    ):
        self._source = iter(source)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._device_put = device_put
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._source:
                if self._device_put is not None:
                    batch = self._device_put(batch)
                self._queue.put(batch)
        except BaseException as e:  # propagate into the consumer
            self._error = e
        finally:
            self._queue.put(self._SENTINEL)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def pinned_device_put(device) -> Callable[[Dict[str, np.ndarray]], Dict[str, Any]]:
    """A ``device_put`` for ``PrefetchIterator``: numpy arrays become tensors
    on ``device`` (through pinned memory and an asynchronous copy on a CUDA
    device); keys that start with ``_`` pass through untouched. The count of
    audio samples is taken here, on the host, as ``_num_audio_samples``."""
    device = torch.device(device)

    def put(batch):
        out = {}
        for k, v in batch.items():
            if k.startswith("_"):
                out[k] = v
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        for key in ("input_values_lengths", "input_lengths", "label_lengths"):
            if key in batch and "_num_audio_samples" not in out:
                out["_num_audio_samples"] = int(np.sum(batch[key]))
        return out

    return put
