"""Materialize a corpus builder to disk (counterpart of
``huggingface_asr_tpu/cli/preprocess_dataset.py``; reference:
src/dataset_builders/preprocess_dataset.py:21-37).

    python -m huggingface_asr_tpu_torch.cli.preprocess_dataset --builder kaldi \
        --source_dir data/train --output_dir dataset
"""

from __future__ import annotations

import dataclasses
import logging

from huggingface_asr_tpu_torch.cli.common import setup_logging
from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class PreprocessArguments:
    builder: str = "kaldi"  # kaldi | audio_folder_vad
    source_dir: str = ""
    output_dir: str = "dataset"
    sampling_rate: int = 16000
    use_pyannote: bool = False
    num_shards: int = 1


def main(argv=None):
    parser = DataclassArgumentParser([PreprocessArguments])
    (args,) = parser.parse_args_into_dataclasses(argv)
    setup_logging(args.output_dir)

    if args.builder == "kaldi":
        from huggingface_asr_tpu_torch.data.builders import build_kaldi_dataset

        ds = build_kaldi_dataset(args.source_dir, args.sampling_rate)
    elif args.builder == "audio_folder_vad":
        from huggingface_asr_tpu_torch.data.builders import build_audio_folder_vad_dataset

        ds = build_audio_folder_vad_dataset(
            args.source_dir, args.sampling_rate, args.use_pyannote
        )
    else:
        raise ValueError(args.builder)

    ds.save_to_disk(args.output_dir, num_shards=args.num_shards)
    logger.info("saved %d examples to %s", len(ds), args.output_dir)
    return ds


if __name__ == "__main__":
    main()
