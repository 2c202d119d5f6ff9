"""Length-bucketed batching with frame quantization (the port's own copy of
``huggingface_asr_tpu/data/bucketing.py``; numpy only).

Utterances are grouped by length into batches, and each batch is padded to a
quantized length (a multiple of ``pad_to_multiple``, or the next of a fixed
bucket set). Quantization bounds the number of distinct batch shapes, which
keeps the allocator's and the kernels' shapes few; length grouping keeps the
padding waste low.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketingConfig:
    batch_size: int = 64
    pad_to_multiple: int = 1600  # samples (=0.1 s at 16 kHz); frames: use 100
    num_length_groups: int = 50  # granularity of length grouping (megabatches)
    seed: int = 42
    drop_last: bool = False
    # Optional hard bucket set (upper bounds). When set, lengths quantize up
    # to the nearest bucket instead of the nearest multiple.
    buckets: Optional[Sequence[int]] = None


def quantize_length(length: int, config: BucketingConfig) -> int:
    """Smallest allowed padded length >= length."""
    if config.buckets:
        for b in sorted(config.buckets):
            if length <= b:
                return b
        return max(config.buckets)
    m = config.pad_to_multiple
    return ((length + m - 1) // m) * m


class BucketedBatchSampler:
    """Shuffled length-grouped batch sampler (HF LengthGroupedSampler analogue).

    Each epoch: shuffle indices, slice into megabatches of
    ``num_length_groups * batch_size``, sort each megabatch by length, emit
    consecutive batches. Supports per-host sharding for multi-host input:
    host h of H takes batches [h::H].
    """

    def __init__(
        self,
        lengths: Sequence[int],
        config: BucketingConfig = BucketingConfig(),
        num_hosts: int = 1,
        host_id: int = 0,
    ):
        self.lengths = np.asarray(lengths)
        self.config = config
        self.num_hosts = num_hosts
        self.host_id = host_id

    def epoch_batches(self, epoch: int) -> Iterator[List[int]]:
        cfg = self.config
        rng = np.random.default_rng(cfg.seed + epoch)
        order = rng.permutation(len(self.lengths))
        mega = cfg.num_length_groups * cfg.batch_size
        batches = []
        for start in range(0, len(order), mega):
            chunk = order[start : start + mega]
            chunk = chunk[np.argsort(self.lengths[chunk], kind="stable")[::-1]]
            for b in range(0, len(chunk), cfg.batch_size):
                batch = chunk[b : b + cfg.batch_size]
                if cfg.drop_last and len(batch) < cfg.batch_size:
                    continue
                batches.append(batch.tolist())
        # Shuffle batch order so length groups aren't presented monotonically.
        rng.shuffle(batches)
        for i, batch in enumerate(batches):
            if i % self.num_hosts == self.host_id:
                yield batch

    def __iter__(self):
        return self.epoch_batches(0)
