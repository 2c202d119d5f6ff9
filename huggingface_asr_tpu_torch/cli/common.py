"""What the command-line entry points share (counterpart of
``huggingface_asr_tpu/cli/common.py``; its ``setup_compile_cache`` is the
XLA compile cache and has no counterpart).

``datasets`` and ``transformers`` are imported inside the loaders only: a
caller that brings its own dataset mapping and tokenizer needs neither.
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from huggingface_asr_tpu_torch.data.bucketing import BucketedBatchSampler
from huggingface_asr_tpu_torch.data.collator import SpeechCollator
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig, GPT2MultiHeadDecoder
from huggingface_asr_tpu_torch.parallel.distributed import host_barrier
from huggingface_asr_tpu_torch.parallel.mesh import Mesh
from huggingface_asr_tpu_torch.training.model_factory import load_config, load_state, save_params
from huggingface_asr_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def setup_logging(output_dir: Optional[str] = None, level=logging.INFO):
    """Log to stderr, and on rank 0 (torchrun's ``RANK``) to ``output_dir/train.log``."""
    handlers = [logging.StreamHandler()]
    if output_dir and os.environ.get("RANK", "0") == "0":
        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(output_dir, "train.log")))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )


def load_tokenizer(name_or_path: str):
    """Load an HF fast tokenizer from a local dir/file or the hub."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(name_or_path)


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


def load_fusion_lm(gen_args, device="cuda", dtype: torch.dtype = torch.bfloat16) -> Optional[GPT2MultiHeadDecoder]:
    """The external shallow-fusion LM named by ``--lm_model`` (reference
    train_enc_dec_asr.py:61-77, shallow_fussion.py:5-53): a ``final/`` that
    ``cli/train_clm.py`` wrote (``config.json`` + ``pytorch_model.bin``, a
    decoder without cross-attention), in the serving layout of ``dtype`` on
    ``device``, for ``generate_joint``'s ``lm``; None where fusion is off (no
    ``lm_model``, or ``lm_weight`` 0)."""
    if not getattr(gen_args, "lm_model", None) or gen_args.lm_weight == 0.0:
        return None
    lm = GPT2MultiHeadDecoder(load_config(gen_args.lm_model, GPT2DecoderConfig), dtype)
    lm.load_state_dict(load_state(gen_args.lm_model), strict=True)
    logger.info("shallow-fusion LM loaded from %s (weight %.3f)", gen_args.lm_model, gen_args.lm_weight)
    return lm.to(resolve_device(device)).eval()


def dataset_lengths(dataset, length_column: str) -> np.ndarray:
    if length_column in dataset.column_names:
        return np.asarray(dataset[length_column], dtype=np.float64)
    raise KeyError(f"dataset lacks length column {length_column}")


def epoch_iterator(
    dataset,
    sampler: BucketedBatchSampler,
    collator: SpeechCollator,
    max_steps: Optional[int] = None,
    extra_fn: Optional[Callable[[dict], dict]] = None,
    mesh: Optional[Mesh] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite (or max_steps-bounded) epoch-cycling batch iterator. Each
    batch carries ``_num_audio_samples``, counted on the host, for ``fit``'s
    throughput. Under a ``mesh`` of more than one ``data`` rank every rank
    walks the same global batches and collates its own rows of each
    (``SpeechCollator``'s ``rows``; a batch size that ``data`` does not
    divide raises)."""
    step = 0
    split = mesh is not None and mesh.data > 1
    for epoch in itertools.count():
        for idx in sampler.epoch_batches(epoch):
            examples = [dataset[int(i)] for i in idx]
            batch = collator(examples, rows=mesh.rows(len(idx))) if split else collator(examples)
            if extra_fn is not None:
                batch = extra_fn(batch)
            for key in ("_all_lengths", "input_values_lengths", "input_lengths", "label_lengths"):
                if key in batch:
                    batch["_num_audio_samples"] = np.asarray(
                        np.sum(batch[key]), np.int64
                    )
                    break
            else:
                if "input_ids" in batch:
                    batch["_num_audio_samples"] = np.asarray(
                        np.prod(batch["input_ids"].shape), np.int64
                    )
            yield batch
            step += 1
            if max_steps is not None and step >= max_steps:
                return


def eval_batches(
    dataset,
    collator: SpeechCollator,
    batch_size: int,
) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-batch-size eval iterator.

    The last ragged batch is padded to ``batch_size`` by repeating the final
    example, so every eval batch has the same leading shape, as in the JAX
    package. The number of real rows rides along as ``batch["_num_real"]``;
    consumers pop it and truncate their outputs with it.
    """
    n = len(dataset)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        num_real = len(idx)
        idx += [idx[-1]] * (batch_size - num_real)
        batch = collator([dataset[i] for i in idx])
        batch["_num_real"] = np.asarray(num_real, np.int32)
        yield batch


def save_final(trainer, output_dir: str) -> str:
    """``output_dir/final`` (``config.json`` + ``pytorch_model.bin``) of the
    trainer's model, written by rank 0; every rank waits until it exists."""
    final_dir = os.path.join(output_dir, "final")
    if trainer.mesh.is_primary:
        save_params(trainer.model, final_dir)
    host_barrier("final")
    return final_dir


def split_references(dataset, text_column: str) -> List[str]:
    return list(dataset[text_column])
