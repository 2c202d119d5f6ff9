"""Standalone decode/evaluation entry point (counterpart of
``huggingface_asr_tpu/cli/evaluate.py``).

Covers the reference's eval paths — ``do_evaluate`` with generation-config
override strings and per-split CSV/trn outputs (reference:
src/utilities/general_utils.py:129-228) — for the port's model directories:
CTC greedy decode for E-Branchformer CTC models (``--model_type ctc``), joint
CTC/attention beam search for AED models (``--model_type aed``, with
``--save_nbest``'s ``nbest_*`` files and ``--lm_model``'s shallow fusion of a
``cli/train_clm.py`` LM at ``--lm_weight``), CTC greedy decode (blank
``blank_token_id``) for Whisper-encoder CTC models (``--model_type
whisper_ctc``, ``WhisperCTCRoute``) and the LLM's greedy decode over the
soft-prompted frames for LLM-ASR models (``--model_type llm_asr``,
``LLMASRRoute``, at most ``--max_length`` tokens).

``--fused_encoder`` (the CTC route): "auto" takes the kernel route (the
log-mel kernel, then ``ctc_infer``: the subsampler and layer kernels, then the
heads) where the device is a card and ``fused_encoder_refusal(config, dtype,
log_mel=True)`` is None; "on" requires it and raises with the reason
otherwise; "off" runs the plain model behind the plain log-mel front end. The
AED route (``AedRoute``, which ``cli/train_aed.py``'s final evaluation runs
too) hands the same choice to ``generate_joint`` ("on" -> True, "off" ->
False). The recipe routes' encoders are plain transformers with no kernel
of their own; there the choice is the front end's (``recipe_frontend``):
"auto" runs the log-mel and CMVN kernels (``kernels/mel.py::MelFrontEnd``)
on a card for a bfloat16 model whose bank they take (at most ``MEL_MAX_BINS``,
128, mel bins: ``kernels/mel.py::mel_bins_refusal``)
and the plain ``LogMelFrontEnd`` otherwise, logging why on a card; "on"
requires the kernels and raises with the reason; "off" runs the plain front
end. On a card a kernel that does not build or launch ends the run with its
error: nothing falls back.

``main(argv)`` parses the arguments and loads the dataset and the tokenizer
(through ``datasets`` and ``transformers``); ``run`` does the rest, for a
caller that brings its own dataset mapping and tokenizer.

    python -m huggingface_asr_tpu_torch.cli.evaluate --dataset_name DIR --load_from_disk \\
        --tokenizer_name TOK --from_pretrained out/final --model_type ctc [--device cpu]
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from huggingface_asr_tpu_torch.cli.common import (
    eval_batches,
    load_fusion_lm,
    load_tokenizer,
    setup_logging,
    split_references,
    tokenizer_ids,
)
from huggingface_asr_tpu_torch.data.bucketing import BucketingConfig
from huggingface_asr_tpu_torch.data.collator import CollatorConfig, SpeechCollator
from huggingface_asr_tpu_torch.data.datasets import DataConfig, get_dataset
from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig
from huggingface_asr_tpu_torch.decoding.generate import generate_joint
from huggingface_asr_tpu_torch.kernels.mel import MelFrontEnd, mel_bins_refusal
from huggingface_asr_tpu_torch.models.configs import parse_dtype
from huggingface_asr_tpu_torch.models.ebranchformer import CTCOutput, EBranchformerForCTC
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer, fused_encoder_refusal
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2MultiHeadDecoder
from huggingface_asr_tpu_torch.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder
from huggingface_asr_tpu_torch.ops.ctc import ctc_greedy_decode, tokens_to_lists
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
from huggingface_asr_tpu_torch.training.arguments import GenerationArguments, ModelArguments, check_supported
from huggingface_asr_tpu_torch.training.model_factory import (
    load_aed_model,
    load_ctc_model,
    load_llm_asr_model,
    load_whisper_ctc_model,
)
from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser, parse_override_string
from huggingface_asr_tpu_torch.utils.device import resolve_device
from huggingface_asr_tpu_torch.utils.eval_utils import evaluate_splits, save_nbests

logger = logging.getLogger(__name__)

FUSED_CHOICES = {"auto": "auto", "on": True, "off": False}


@dataclasses.dataclass(frozen=True)
class EvalArguments:
    output_dir: str = "eval_output"
    batch_size: int = 32
    model_type: str = "ctc"  # ctc | aed | whisper_ctc | llm_asr
    # "auto": the kernel route when on a card and the config/dtype qualify;
    # "on": require it; "off": the plain model.
    fused_encoder: str = "auto"  # auto | on | off


def build_generation_config(gen_args: GenerationArguments, ids) -> BeamSearchConfig:
    """The port's own copy of ``huggingface_asr_tpu/cli/train_aed.py::build_generation_config``."""
    return BeamSearchConfig(
        num_beams=max(gen_args.num_beams, 1),
        max_length=gen_args.max_length,
        ctc_weight=gen_args.ctc_weight,
        ctc_margin=gen_args.ctc_margin,
        lm_weight=gen_args.lm_weight,
        length_penalty=gen_args.length_penalty,
        num_candidates=gen_args.num_candidates,
        bos_token_id=ids["bos"],
        eos_token_id=ids["eos"],
        pad_token_id=ids["pad"],
        apply_eos_space_trick=gen_args.apply_eos_space_trick,
        space_token_id=gen_args.space_token_id,
        eos_space_trick_weight=gen_args.eos_space_trick_weight,
    )


def evaluation_generation_config(gen_args: GenerationArguments, ids) -> BeamSearchConfig:
    """The joint search of an evaluation: ``build_generation_config``, then
    ``--override_for_evaluation``, then the beams multiplied by
    ``--eval_beam_factor`` (reference do_evaluate, general_utils.py:200-203;
    the caller divides its batch by the factor)."""
    gen_cfg = build_generation_config(gen_args, ids)
    if gen_args.override_for_evaluation:
        gen_cfg = parse_override_string(gen_args.override_for_evaluation, gen_cfg)
    if gen_args.eval_beam_factor > 1:
        gen_cfg = dataclasses.replace(gen_cfg, num_beams=gen_cfg.num_beams * gen_args.eval_beam_factor)
    return gen_cfg


class CTCRoute:
    """The CTC route's front end and encoder, chosen once by
    ``fused_encoder``: ``route(waveforms, lengths)`` -> ``CTCOutput`` (logits
    in the route's dtype, decode lengths)."""

    def __init__(self, model: EBranchformerForCTC, fused_encoder: str, device: torch.device, dtype: torch.dtype):
        if fused_encoder not in FUSED_CHOICES:
            raise ValueError(f"--fused_encoder {fused_encoder!r}: auto, on or off")
        refusal = fused_encoder_refusal(model.config, dtype, log_mel=True)
        if refusal is None and device.type != "cuda":
            refusal = f"device {device} (the kernels run on a CUDA device)"
        if fused_encoder == "on" and refusal is not None:
            raise ValueError(f"--fused_encoder on, but the kernel route does not take this model: {refusal}")
        self.fused = fused_encoder != "off" and refusal is None
        if fused_encoder == "auto" and refusal is not None and device.type == "cuda":
            logger.warning("CTC decode through the plain model, not the kernels: %s", refusal)
        mel_cfg = LogMelConfig(num_mel_bins=model.config.num_fbanks)
        self.dtype = dtype
        if self.fused:
            logger.info("CTC decode through the kernel route")
            self._frontend = MelFrontEnd(mel_cfg, device=device)
            self._encoder = FusedCTC(model, device)
        else:
            self._frontend = LogMelFrontEnd(mel_cfg)
            self._model = model

    @torch.inference_mode()
    def __call__(self, waveforms: torch.Tensor, lengths: torch.Tensor) -> CTCOutput:
        feats, feat_lens = self._frontend(waveforms, lengths)
        if self.fused:
            return ctc_infer(self._encoder, feats, feat_lens)
        return self._model(feats.to(self.dtype), feat_lens)


def recipe_frontend_refusal(device: torch.device, num_mel_bins: Optional[int] = None,
                            dtype: Optional[torch.dtype] = None) -> Optional[str]:
    """The first condition of the log-mel and CMVN kernels that a recipe
    route fails, as a sentence, or None (``num_mel_bins`` and ``dtype`` are
    checked where given; the bins as ``kernels/mel.py::mel_bins_refusal``
    checks them)."""
    mel_refusal = None if num_mel_bins is None else mel_bins_refusal(num_mel_bins)
    checks = (
        (device.type == "cuda", f"device {device} (the kernels run on a CUDA device)"),
        (mel_refusal is None, f"num_mel_bins {num_mel_bins} {mel_refusal}"),
        (dtype is None or dtype == torch.bfloat16, f"dtype {dtype} (the CMVN kernel writes bfloat16 features)"),
    )
    return next((reason for ok, reason in checks if not ok), None)


def recipe_frontend(num_mel_bins: int, fused_encoder: str, device: torch.device, dtype: torch.dtype, what: str):
    """(front end, whether it runs the kernels) of a recipe route:
    ``MelFrontEnd`` (the log-mel and CMVN kernels, bf16 features) where
    ``fused_encoder`` allows it and the kernels take the model, else the
    plain ``LogMelFrontEnd`` (fp32 features). "on" raises where the kernels
    do not take it; "auto" on a card logs the reason."""
    if fused_encoder not in FUSED_CHOICES:
        raise ValueError(f"--fused_encoder {fused_encoder!r}: auto, on or off")
    refusal = recipe_frontend_refusal(device, num_mel_bins, dtype)
    if fused_encoder == "on" and refusal is not None:
        raise ValueError(f"--fused_encoder on, but the log-mel kernels do not take this model: {refusal}")
    mel_cfg = LogMelConfig(num_mel_bins=num_mel_bins)
    if fused_encoder != "off" and refusal is None:
        logger.info("%s front end through the log-mel and CMVN kernels", what)
        return MelFrontEnd(mel_cfg, device=device), True
    if fused_encoder == "auto" and device.type == "cuda":
        logger.warning("%s front end through the plain log-mel, not the kernels: %s", what, refusal)
    return LogMelFrontEnd(mel_cfg), False


class WhisperCTCRoute:
    """The Whisper-encoder CTC route: ``recipe_frontend``, then the model in
    ``dtype``. ``route(waveforms, lengths)`` -> ``CTCOutput``."""

    def __init__(self, model, fused_encoder: str, device: torch.device, dtype: torch.dtype):
        self.frontend, self.fused = recipe_frontend(model.config.num_mel_bins, fused_encoder, device, dtype,
                                                    "Whisper-CTC")
        self.model, self.dtype = model, dtype

    @torch.inference_mode()
    def __call__(self, waveforms: torch.Tensor, lengths: torch.Tensor) -> CTCOutput:
        feats, feat_lens = self.frontend(waveforms, lengths)
        return self.model(feats.to(self.dtype), feat_lens)


class LLMASRRoute:
    """The LLM-ASR route: ``recipe_frontend``, then ``llm_asr_greedy_decode``
    of at most ``max_len`` tokens. ``route(waveforms, lengths)`` -> (tokens
    (B, max_len), lengths (B,))."""

    def __init__(self, model, fused_encoder: str, device: torch.device, max_len: int):
        self.frontend, self.fused = recipe_frontend(model.config.encoder.num_mel_bins, fused_encoder, device,
                                                    model.dtype, "LLM-ASR")
        self.model, self.max_len = model, max_len

    @torch.inference_mode()
    def __call__(self, waveforms: torch.Tensor, lengths: torch.Tensor):
        from huggingface_asr_tpu_torch.models.llm_asr import llm_asr_greedy_decode

        feats, feat_lens = self.frontend(waveforms, lengths)
        return llm_asr_greedy_decode(self.model, feats, feat_lens, max_len=self.max_len)


class AedRoute:
    """The AED route: the plain log-mel front end, then ``generate_joint``
    with the encoder route chosen once by ``fused_encoder`` (the folded
    kernel operands kept) and an optional fusion ``lm``.
    ``route(waveforms, lengths)`` -> the (B, W, L) sequences on the host;
    with ``save_nbest`` it also keeps every batch's scores and score
    components for ``write_nbests``."""

    def __init__(self, model: JointCTCAttentionEncoderDecoder, gen_cfg: BeamSearchConfig, fused_encoder: str,
                 device: torch.device, lm: Optional[GPT2MultiHeadDecoder] = None, save_nbest: bool = False):
        if fused_encoder not in FUSED_CHOICES:
            raise ValueError(f"--fused_encoder {fused_encoder!r}: auto, on or off")
        use_fused = FUSED_CHOICES[fused_encoder]
        refusal = fused_encoder_refusal(model.config.encoder, model.dtype)
        if use_fused is True and refusal is not None:
            raise ValueError(f"--fused_encoder on, but the kernel path does not take this encoder: {refusal}")
        if use_fused == "auto":
            use_fused = device.type == "cuda" and refusal is None
        self.use_fused = use_fused
        self.fused = FusedCTC(model.encoder, device) if use_fused else None  # folded once, not per batch
        self.model, self.lm = model, lm
        self.frontend = LogMelFrontEnd(LogMelConfig(num_mel_bins=model.config.encoder.num_fbanks))
        self.gen_cfg = dataclasses.replace(gen_cfg, return_components=True) if save_nbest else gen_cfg
        self.save_nbest = save_nbest
        self.nbest: List[Any] = []

    @torch.inference_mode()
    def __call__(self, waveforms: torch.Tensor, lengths: torch.Tensor) -> np.ndarray:
        feats, lens = self.frontend(waveforms, lengths)
        out = generate_joint(self.model, feats, lens, self.gen_cfg, lm=self.lm, fused_encoder=self.use_fused,
                             fused=self.fused)
        if self.save_nbest:
            seqs, scores, comps = out
            self.nbest.append((seqs.cpu().numpy(), scores.cpu().numpy(),
                               {k: v.cpu().numpy() for k, v in comps.items()}))
            return self.nbest[-1][0]
        return out[0].cpu().numpy()

    def write_nbests(self, output_dir: str, detokenize: Callable[[List[int]], str]) -> None:
        """``nbest_hyps.txt`` / ``nbest_scores.txt`` and one
        ``nbest_{att,ctc,lm}_scores.txt`` a score component (reference
        postprocess_beam_outputs, general_utils.py:115-126), over every batch
        decoded so far."""
        if not self.nbest:
            return
        seqs = np.concatenate([s for s, _, _ in self.nbest], axis=0)
        scores = np.concatenate([s for _, s, _ in self.nbest], axis=0)
        save_nbests(os.path.join(output_dir, "nbest"), seqs, scores, detokenize)
        for name in ("att", "ctc", "lm"):
            comp = np.concatenate([c[name] for _, _, c in self.nbest], axis=0)
            with open(os.path.join(output_dir, f"nbest_{name}_scores.txt"), "w") as f:
                for i in range(comp.shape[0]):
                    for w in range(comp.shape[1]):
                        f.write(f"utt_{i}-{w} {comp[i, w]:.6f}\n")


def main(argv=None):
    parser = DataclassArgumentParser(
        [EvalArguments, ModelArguments, GenerationArguments, DataConfig]
    )
    eval_args, model_args, gen_args, data_cfg = parser.parse_args_into_dataclasses(argv)
    check_supported(eval_args.model_type)
    setup_logging(eval_args.output_dir)

    dataset = get_dataset(data_cfg)
    tokenizer = load_tokenizer(model_args.tokenizer_name)
    return run(eval_args, model_args, gen_args, data_cfg, dataset, tokenizer)


def run(
    eval_args: EvalArguments,
    model_args: ModelArguments,
    gen_args: GenerationArguments,
    data_cfg: DataConfig,
    dataset: Mapping[str, Any],
    tokenizer,
) -> Dict[str, Any]:
    """Decode and score every split but the train split; returns
    ``evaluate_splits``' results (split -> ``SplitResult``)."""
    check_supported(eval_args.model_type)
    if eval_args.model_type not in ("ctc", "aed", "whisper_ctc", "llm_asr"):
        raise ValueError(f"--model_type {eval_args.model_type!r}: ctc, aed, whisper_ctc or llm_asr")
    device = resolve_device(model_args.device)
    ids = tokenizer_ids(tokenizer)
    dtype = parse_dtype(model_args.dtype)

    def to_device(batch):
        return (torch.from_numpy(batch["input_values"]).to(device),
                torch.from_numpy(batch["input_values_lengths"]).to(device))

    refusal = recipe_frontend_refusal(device)
    if eval_args.model_type in ("whisper_ctc", "llm_asr") and eval_args.fused_encoder == "on" and refusal:
        # before any weights are read
        raise ValueError(f"--fused_encoder on, but the log-mel kernels do not take this model: {refusal}")

    route = None
    if eval_args.model_type == "ctc":
        ctc_route = CTCRoute(load_ctc_model(model_args.from_pretrained, device), eval_args.fused_encoder, device,
                             dtype)

        def decode_batch(batch):
            out = ctc_route(*to_device(batch))
            toks, tlens = ctc_greedy_decode(out.logits, out.logit_lengths, blank_id=-1)
            return [
                tokenizer.decode(t, skip_special_tokens=True)
                for t in tokens_to_lists(toks.cpu().numpy(), tlens.cpu().numpy())
            ], None

    elif eval_args.model_type == "whisper_ctc":
        model = load_whisper_ctc_model(model_args.from_pretrained, device, dtype)
        whisper_route = WhisperCTCRoute(model, eval_args.fused_encoder, device, dtype)

        def decode_batch(batch):
            out = whisper_route(*to_device(batch))
            toks, tlens = ctc_greedy_decode(out.logits, out.logit_lengths, blank_id=model.config.blank_token_id)
            return [
                tokenizer.decode(t, skip_special_tokens=True)
                for t in tokens_to_lists(toks.cpu().numpy(), tlens.cpu().numpy())
            ], None

    elif eval_args.model_type == "llm_asr":
        llm_route = LLMASRRoute(load_llm_asr_model(model_args.from_pretrained, device, dtype), eval_args.fused_encoder,
                                device, gen_args.max_length)

        def decode_batch(batch):
            toks, tlens = llm_route(*to_device(batch))
            return [
                tokenizer.decode(t, skip_special_tokens=True)
                for t in tokens_to_lists(toks.cpu().numpy(), tlens.cpu().numpy())
            ], None

    else:
        model = load_aed_model(model_args.from_pretrained, device, dtype)
        eval_args = dataclasses.replace(
            eval_args, batch_size=max(eval_args.batch_size // max(gen_args.eval_beam_factor, 1), 1))
        route = AedRoute(model, evaluation_generation_config(gen_args, ids), eval_args.fused_encoder, device,
                         load_fusion_lm(gen_args, device, dtype), gen_args.save_nbest)

        def decode_batch(batch):
            seqs = route(*to_device(batch))
            return [
                tokenizer.decode([int(t) for t in row[0]], skip_special_tokens=True)
                for row in seqs
            ], None

    collator = SpeechCollator(
        CollatorConfig(bucketing=BucketingConfig(batch_size=eval_args.batch_size,
                                                 pad_to_multiple=16000))
    )
    test_splits = {
        name: ds for name, ds in dataset.items() if name != data_cfg.train_split
    }
    normalizer = None
    if gen_args.post_process_predictions:
        from huggingface_asr_tpu_torch.utils.normalizer import EnglishNormalizer

        normalizer = EnglishNormalizer()
    results = evaluate_splits(
        decode_batch,
        {n: eval_batches(ds, collator, eval_args.batch_size) for n, ds in test_splits.items()},
        {n: split_references(ds, data_cfg.text_column_name) for n, ds in test_splits.items()},
        output_dir=eval_args.output_dir,
        normalizer=normalizer,
    )
    if route is not None:
        route.write_nbests(eval_args.output_dir, lambda toks: tokenizer.decode(toks, skip_special_tokens=True))
    return results


if __name__ == "__main__":
    main()
