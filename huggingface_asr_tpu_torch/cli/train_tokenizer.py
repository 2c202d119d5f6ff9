"""Tokenizer training entry point (counterpart of
``huggingface_asr_tpu/cli/train_tokenizer.py``; reference:
src/trainers/train_tokenizer.py).

Trains a BPE/Unigram tokenizer (HF ``tokenizers``) on dataset text plus
optional external raw text files, adds the "$A <eos>" template post-processor
(reference :63-70), and saves a PreTrainedTokenizerFast directory.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, List

from huggingface_asr_tpu_torch.cli.common import setup_logging
from huggingface_asr_tpu_torch.data.datasets import DataConfig, get_dataset
from huggingface_asr_tpu_torch.training.arguments import TokenizerTrainingArguments
from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser

logger = logging.getLogger(__name__)


def text_iterator(texts: List[str], extra_files) -> Iterator[str]:
    yield from texts
    for path in extra_files or []:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


def train_tokenizer(
    texts: Iterator[str], args: TokenizerTrainingArguments
):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors, trainers

    special = [args.bos_token, args.eos_token, args.unk_token, args.pad_token, args.mask_token]
    if args.tokenizer_type == "BPE":
        tokenizer = Tokenizer(models.BPE(unk_token=args.unk_token))
        trainer = trainers.BpeTrainer(
            vocab_size=args.vocab_size, special_tokens=special
        )
    elif args.tokenizer_type == "unigram":
        tokenizer = Tokenizer(models.Unigram())
        trainer = trainers.UnigramTrainer(
            vocab_size=args.vocab_size, special_tokens=special,
            unk_token=args.unk_token,
        )
    else:
        raise NotImplementedError(args.tokenizer_type)
    tokenizer.pre_tokenizer = pre_tokenizers.Metaspace()
    tokenizer.decoder = decoders.Metaspace()
    tokenizer.train_from_iterator(texts, trainer)

    # "$A <eos>" template, bos available for AED decoding (reference :63-70).
    tokenizer.post_processor = processors.TemplateProcessing(
        single=f"$A {args.eos_token}",
        pair=f"$A {args.eos_token} $B:1 {args.eos_token}:1",
        special_tokens=[
            (args.bos_token, tokenizer.token_to_id(args.bos_token)),
            (args.eos_token, tokenizer.token_to_id(args.eos_token)),
        ],
    )
    return tokenizer


def wrap_and_save(tokenizer, args: TokenizerTrainingArguments):
    from transformers import PreTrainedTokenizerFast

    wrapped = PreTrainedTokenizerFast(
        tokenizer_object=tokenizer,
        bos_token=args.bos_token,
        eos_token=args.eos_token,
        unk_token=args.unk_token,
        pad_token=args.pad_token,
        mask_token=args.mask_token,
    )
    os.makedirs(args.tokenizer_output_dir, exist_ok=True)
    wrapped.save_pretrained(args.tokenizer_output_dir)
    return wrapped


def main(argv=None):
    parser = DataclassArgumentParser([TokenizerTrainingArguments, DataConfig])
    tok_args, data_cfg = parser.parse_args_into_dataclasses(argv)
    setup_logging(tok_args.tokenizer_output_dir)

    dataset = get_dataset(data_cfg)
    texts = list(dataset[data_cfg.train_split][data_cfg.text_column_name])
    tokenizer = train_tokenizer(
        text_iterator(texts, tok_args.additional_raw_text_files), tok_args
    )
    wrapped = wrap_and_save(tokenizer, tok_args)
    logger.info("saved tokenizer with vocab %d to %s", len(wrapped),
                tok_args.tokenizer_output_dir)
    return wrapped


if __name__ == "__main__":
    main()
