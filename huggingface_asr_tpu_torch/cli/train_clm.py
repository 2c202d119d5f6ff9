"""Causal LM training entry point (counterpart of ``huggingface_asr_tpu/cli/train_clm.py``;
reference: src/trainers/train_clm.py).

Trains the GPT-2 decoder without cross-attention on text: the external LM of
shallow fusion (``cli/common.py::load_fusion_lm``, ``evaluate --lm_model``)
and a DeCRED decoder's initialisation. Text is packed into blocks of
``--block_size`` tokens (``packed_text_batches``: HF run_clm's
concatenate-and-chunk, one numpy permutation an epoch, as the JAX function
draws it); ``CLMTrainer`` steps on the device (the decoder's loss with labels
over fp32 weights, as the JAX CLI trains it, perplexity as a metric); the
evaluation is the token-weighted perplexity of one pass over the validation
text (``packed_eval_batches``). ``final/`` holds ``config.json`` +
``pytorch_model.bin``.

``--skip_if_exists`` (default on) returns at once where ``final/`` exists;
``--restart_from`` resumes from the newest checkpoint, and without it a run
resumes from its output directory's newest checkpoint where there is one.
``--from_hf_gpt2 DIR`` starts from an HF GPT-2 checkpoint directory
(``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``): its keys
are the decoder's own, and its tied ``lm_head`` becomes an untied copy of the
embedding table, as the JAX CLI converts it; a tokenizer larger than its
vocabulary raises.

``main(argv)`` reads the text (``--train_text_file`` /
``--validation_text_file``, one utterance a line, else the dataset's text
column through ``datasets``) and the tokenizer (``transformers``); ``run``
does the rest, for a caller that brings its texts and tokenizer.

    python -m huggingface_asr_tpu_torch.cli.train_clm --tokenizer_name TOK --train_text_file train.txt \\
        --validation_text_file dev.txt --output_dir lm [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from huggingface_asr_tpu_torch.cli.common import load_tokenizer, save_final, setup_logging, tokenizer_ids
from huggingface_asr_tpu_torch.cli.train_ctc import build_trainer_config
from huggingface_asr_tpu_torch.data.datasets import DataConfig, get_dataset
from huggingface_asr_tpu_torch.models.gpt2_decoder import (
    GPT2DecoderConfig,
    GPT2MultiHeadDecoder,
    init_decoder_from_scratch_,
)
from huggingface_asr_tpu_torch.parallel.distributed import initialize_distributed
from huggingface_asr_tpu_torch.training.arguments import GeneralTrainingArguments, ModelArguments
from huggingface_asr_tpu_torch.training.loop import BaseTrainer
from huggingface_asr_tpu_torch.training.model_factory import checkpoint_steps
from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser
from huggingface_asr_tpu_torch.utils.logging_utils import MetricsLogger

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CLMArguments:
    block_size: int = 256
    n_embd: int = 256
    n_layer: int = 6
    n_head: int = 4
    head_locations: tuple = ()
    head_weights: tuple = (1.0,)
    skip_if_exists: bool = True
    # raw text files, one utterance a line; when set they replace the dataset's text
    train_text_file: str = ""
    validation_text_file: str = ""
    # an HF GPT-2 checkpoint directory to start from
    from_hf_gpt2: str = ""
    max_eval_blocks: int = 0  # cap on the evaluation batches of one pass; 0 = no cap


class CLMTrainer(BaseTrainer):
    """The decoder's loss with labels; ``ppl`` = exp(min(loss, 20))."""

    def loss_and_metrics(self, batch, aug_gen, dropout_rng, step):
        out = self.model(batch["input_ids"], labels=batch["labels"], label_mask=batch["label_mask"], rng=dropout_rng)
        return out.loss, {}

    def train_step(self, state, batch):
        state, metrics = super().train_step(state, batch)
        # from the loss summed over the ranks
        metrics["ppl"] = torch.exp(torch.clamp(metrics["loss"], max=20.0))
        return state, metrics

    def eval_outputs(self, batch):
        out = self.model(batch["input_ids"], labels=batch["labels"], label_mask=batch["label_mask"])
        return {"loss": out.loss}


def _ids(tokenizer, text: str) -> List[int]:
    ids = tokenizer.encode(text)
    return list(ids.ids) if hasattr(ids, "ids") else list(ids)


def _block_batch(rows: List[List[int]], bos: int) -> Dict[str, np.ndarray]:
    chunk = np.asarray(rows, dtype=np.int32)
    inputs = np.concatenate([np.full((len(rows), 1), bos, np.int32), chunk[:, :-1]], axis=1)
    return {"input_ids": inputs, "labels": chunk, "label_mask": np.ones_like(chunk, dtype=bool)}


def packed_text_batches(texts: Sequence[str], tokenizer, block_size: int, batch_size: int, bos: int,
                        seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Concatenate-and-chunk packing (HF run_clm): the texts of an epoch in one
    ``np.random.default_rng(seed)`` permutation, their ids cut into blocks of
    ``block_size``, ``batch_size`` blocks a batch; inputs are the blocks
    shifted right behind ``bos``. Endless."""
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(len(texts))
        buf: List[int] = []
        rows = []
        for idx in order:
            buf.extend(_ids(tokenizer, texts[int(idx)]))
            while len(buf) >= block_size:
                rows.append(buf[:block_size])
                buf = buf[block_size:]
                if len(rows) == batch_size:
                    yield _block_batch(rows, bos)
                    rows = []


def packed_eval_batches(texts: Sequence[str], tokenizer, block_size: int, batch_size: int,
                        bos: int) -> List[Dict[str, np.ndarray]]:
    """One pass for perplexity: every full block once, in the texts' order;
    the last batch is filled with rows of ``bos`` whose mask is False."""
    buf: List[int] = []
    rows: List[List[int]] = []
    for text in texts:
        buf.extend(_ids(tokenizer, text))
        while len(buf) >= block_size:
            rows.append(buf[:block_size])
            buf = buf[block_size:]
    batches = []
    for i in range(0, len(rows), batch_size):
        chunk_rows = rows[i:i + batch_size]
        n_real = len(chunk_rows)
        chunk_rows += [[bos] * block_size] * (batch_size - n_real)
        batch = _block_batch(chunk_rows, bos)
        batch["label_mask"][n_real:] = False
        batches.append(batch)
    return batches


def load_hf_gpt2(path: str, ids: Dict[str, int]):
    """(config, state dict) of the decoder from an HF GPT-2 checkpoint
    directory. The JAX CLI's config (the checkpoint's sizes, no
    cross-attention, the tokenizer's special ids); a tokenizer larger than
    the checkpoint's vocabulary raises (its ids would index past the table)."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    if ids["vocab_size"] > hf["vocab_size"]:
        raise ValueError(
            f"--tokenizer_name vocab ({ids['vocab_size']}) exceeds {path} vocab ({hf['vocab_size']}); "
            "use the checkpoint's own tokenizer or retrain from scratch")
    config = GPT2DecoderConfig(
        vocab_size=hf["vocab_size"], n_positions=hf["n_positions"], n_embd=hf["n_embd"], n_layer=hf["n_layer"],
        n_head=hf["n_head"], n_inner=hf.get("n_inner"), add_cross_attention=False,
        bos_token_id=ids["bos"], eos_token_id=ids["eos"], pad_token_id=ids["pad"],
    )
    if os.path.exists(os.path.join(path, "model.safetensors")):
        from safetensors.torch import load_file

        sd = load_file(os.path.join(path, "model.safetensors"))
    else:
        sd = torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu", weights_only=True)
    # GPT2LMHeadModel's keys are the decoder's, beside the causal-mask buffers
    # some versions save; a tied lm_head may be left out of the file
    sd = {k: v for k, v in sd.items() if not k.endswith((".attn.bias", ".attn.masked_bias"))}
    sd.setdefault("lm_head.weight", sd["transformer.wte.weight"])
    sd["lm_head.weight"] = sd["lm_head.weight"].clone()
    return config, sd


def main(argv=None):
    parser = DataclassArgumentParser([ModelArguments, GeneralTrainingArguments, CLMArguments, DataConfig])
    model_args, training, clm_args, data_cfg = parser.parse_args_into_dataclasses(argv)
    setup_logging(training.output_dir)
    if "WORLD_SIZE" in os.environ:  # under torchrun: join before the dataset's rank-0-first calls
        initialize_distributed(model_args.device)
    if _skip(clm_args, training):
        return None

    eval_texts: List[str] = []
    if clm_args.train_text_file:
        with open(clm_args.train_text_file) as f:
            texts = [ln.strip() for ln in f if ln.strip()]
        if clm_args.validation_text_file:
            with open(clm_args.validation_text_file) as f:
                eval_texts = [ln.strip() for ln in f if ln.strip()]
    else:
        dataset = get_dataset(dataclasses.replace(data_cfg, audio_column_name=None))
        texts = list(dataset[data_cfg.train_split][data_cfg.text_column_name])
        if data_cfg.validation_split in dataset:
            eval_texts = list(dataset[data_cfg.validation_split][data_cfg.text_column_name])
    tokenizer = load_tokenizer(model_args.tokenizer_name)
    return run(model_args, training, clm_args, texts, eval_texts, tokenizer)


def _skip(clm_args: CLMArguments, training: GeneralTrainingArguments) -> bool:
    final_dir = os.path.join(training.output_dir, "final")
    if clm_args.skip_if_exists and os.path.exists(os.path.join(final_dir, "config.json")):
        logger.info("model already exists at %s, skipping (skip_if_exists)", final_dir)
        return True
    return False


def run(model_args: ModelArguments, training: GeneralTrainingArguments, clm_args: CLMArguments,
        texts: Sequence[str], eval_texts: Sequence[str], tokenizer) -> Optional[Dict[str, float]]:
    """Train, write the last checkpoint and ``final/``; returns the final
    evaluation (``loss``, ``perplexity``; also written to ``clm_eval.json``),
    ``{}`` without validation text, or None where ``skip_if_exists`` skipped."""
    if _skip(clm_args, training):
        return None
    device = initialize_distributed(model_args.device)
    ids = tokenizer_ids(tokenizer)
    if clm_args.from_hf_gpt2:
        config, init_state = load_hf_gpt2(clm_args.from_hf_gpt2, ids)
    else:
        init_state = None
        config = GPT2DecoderConfig(
            vocab_size=ids["vocab_size"], n_positions=clm_args.block_size + 1, n_embd=clm_args.n_embd,
            n_layer=clm_args.n_layer, n_head=clm_args.n_head, head_locations=tuple(clm_args.head_locations),
            head_weights=tuple(clm_args.head_weights), add_cross_attention=False, bos_token_id=ids["bos"],
            eos_token_id=ids["eos"], pad_token_id=ids["pad"], pos_emb_fixed=model_args.decoder_pos_emb_fixed,
        )
    # fp32 compute, as the JAX CLI builds its decoder
    model = GPT2MultiHeadDecoder(config)
    if init_state is None:
        init_decoder_from_scratch_(model, torch.Generator().manual_seed(training.seed))
    else:
        model.load_state_dict(init_state, strict=True)
    trainer = CLMTrainer(model, build_trainer_config(training), device=device, dtype="float32")

    batches = packed_text_batches(texts, tokenizer, clm_args.block_size, training.per_device_train_batch_size,
                                  ids["bos"], training.seed)
    next(batches)  # the JAX CLI's example batch, drawn before training
    state = trainer.init_state()
    ckpt_dir = trainer.config.checkpoint_dir
    if training.restart_from:
        state = trainer.restore_checkpoint(state, None)
    elif checkpoint_steps(ckpt_dir):
        latest = checkpoint_steps(ckpt_dir)[-1]
        logger.info("auto-resuming from checkpoint step %d", latest)
        state = trainer.restore_checkpoint(state, latest)

    def eval_fn(state):
        """Held-out perplexity: one pass over every validation block, the
        token-weighted mean loss."""
        ev = packed_eval_batches(eval_texts, tokenizer, clm_args.block_size, training.per_device_eval_batch_size,
                                 ids["bos"])
        if clm_args.max_eval_blocks:
            ev = ev[:clm_args.max_eval_blocks]
        loss_sum = tok_sum = 0.0
        for batch in ev:
            n_tok = float(batch["label_mask"].sum())
            loss_sum += float(trainer.eval_step(state, batch)["loss"]) * n_tok
            tok_sum += n_tok
        if tok_sum == 0:
            return {}
        mean_loss = loss_sum / tok_sum
        return {"loss": mean_loss, "perplexity": float(np.exp(min(mean_loss, 20.0)))}

    if training.report_to_wandb:
        logger.warning("--report_to_wandb: the port logs to metrics.jsonl only (no W&B sink)")
    metrics_logger = MetricsLogger(training.output_dir)
    state = trainer.fit(state, batches, eval_fn=eval_fn if eval_texts else None, hooks=[metrics_logger.log])
    trainer.save_checkpoint(state)
    save_final(trainer, training.output_dir)
    if not eval_texts:
        return {}
    final_eval = eval_fn(state)
    logger.info("final eval: %s", final_eval)
    if trainer.mesh.is_primary:
        with open(os.path.join(training.output_dir, "clm_eval.json"), "w") as f:
            json.dump(final_eval, f)
    return final_eval


if __name__ == "__main__":
    main()
