"""What the command-line entry points share (counterpart of
``huggingface_asr_tpu/cli/common.py``; ``tokenizer_ids`` only so far)."""

from __future__ import annotations

from typing import Dict


def tokenizer_ids(tokenizer) -> Dict[str, int]:
    """The special ids of an HF-style tokenizer, with the JAX package's
    defaults where it has none (bos 0, eos 1, pad 3)."""
    return {
        "bos": tokenizer.bos_token_id if tokenizer.bos_token_id is not None else 0,
        "eos": tokenizer.eos_token_id if tokenizer.eos_token_id is not None else 1,
        "pad": tokenizer.pad_token_id if tokenizer.pad_token_id is not None else 3,
        "unk": tokenizer.unk_token_id,
        "vocab_size": len(tokenizer),
    }
