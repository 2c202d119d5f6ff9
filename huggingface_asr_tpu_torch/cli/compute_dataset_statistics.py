"""Global CMVN statistics entry point (counterpart of
``huggingface_asr_tpu/cli/compute_dataset_statistics.py``; reference:
src/trainers/compute_dataset_statistics.py).

Computes the per-mel-bin mean and std of the log-mel features over the
train split, summed in float64 (``ops/features.py::compute_global_stats``),
and saves ``global_means.npy``, ``global_stds.npy`` and
``global_stats.json`` for ``LogMelFrontEnd(norm_type="global")``. The
features come from ``kernels/mel.py::MelFrontEnd`` with ``norm_type="none"``:
on the card one launch of the log-mel kernel a batch, on the CPU its plain
version.

``main(argv)`` parses the arguments and loads the dataset (through
``datasets``); ``run`` does the rest, for a caller that brings the train
split as a table of rows (``len`` and rows, such as
``data.datasets.ColumnTable``). ``--device cpu`` runs on the CPU; the default
is the card.

    python -m huggingface_asr_tpu_torch.cli.compute_dataset_statistics --dataset_name DIR --load_from_disk \\
        --output_dir stats [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Tuple

import numpy as np
import torch

from huggingface_asr_tpu_torch.cli.common import eval_batches, setup_logging
from huggingface_asr_tpu_torch.data.bucketing import BucketingConfig
from huggingface_asr_tpu_torch.data.collator import CollatorConfig, SpeechCollator
from huggingface_asr_tpu_torch.data.datasets import DataConfig, get_dataset
from huggingface_asr_tpu_torch.kernels.mel import MelFrontEnd
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, compute_global_stats
from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser
from huggingface_asr_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class StatsArguments:
    output_dir: str = "stats"
    batch_size: int = 64
    max_batches: int = 0  # 0 = all
    # the port's own: where the features are computed ("cuda" or "cpu")
    device: str = "cuda"


def main(argv=None):
    parser = DataclassArgumentParser([StatsArguments, DataConfig])
    args, data_cfg = parser.parse_args_into_dataclasses(argv)
    setup_logging(args.output_dir)
    return run(args, get_dataset(data_cfg)[data_cfg.train_split])


def run(args: StatsArguments, train_rows) -> Tuple[np.ndarray, np.ndarray]:
    """The statistics of ``train_rows``, written under ``args.output_dir``;
    returns ``(means, stds)`` (float64)."""
    device = resolve_device(args.device)
    collator = SpeechCollator(CollatorConfig(bucketing=BucketingConfig(batch_size=args.batch_size,
                                                                       pad_to_multiple=16000)))
    frontend = MelFrontEnd(LogMelConfig(norm_type="none"), device=device)

    def batches():
        for i, batch in enumerate(eval_batches(train_rows, collator, args.batch_size)):
            if args.max_batches and i >= args.max_batches:
                break
            # the repeated rows eval_batches pads the last batch with would bias the statistics
            n = int(batch.pop("_num_real"))
            yield (torch.from_numpy(batch["input_values"][:n]).to(device),
                   torch.from_numpy(batch["input_values_lengths"][:n]).to(device))

    mean, std = compute_global_stats(frontend, batches())
    os.makedirs(args.output_dir, exist_ok=True)
    np.save(os.path.join(args.output_dir, "global_means.npy"), mean)
    np.save(os.path.join(args.output_dir, "global_stds.npy"), std)
    with open(os.path.join(args.output_dir, "global_stats.json"), "w") as f:
        json.dump({"means": mean.tolist(), "stds": std.tolist()}, f)
    logger.info("saved global CMVN stats to %s", args.output_dir)
    return mean, std


if __name__ == "__main__":
    main()
