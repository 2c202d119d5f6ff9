"""LLM-ASR in plain PyTorch: a Whisper-CTC encoder feeding a causal LLM
through soft prompts (counterpart of ``huggingface_asr_tpu/models/llm_asr.py``;
reference: recipes_v0.0.1/librispeech_whisper_ctc/local_models.py:10-243).

The encoder's greedy CTC output is blank-stripped and deduplicated; the
surviving frames' hidden states are projected (``linear``) and spliced into
the LLM input as

    [bos] [soft_prompt x P] [asr frame embeds] [end_prompt] [label embeds...]

with the cross entropy trained on the label tail (plus the encoder's CTC loss
at ``ctc_weight``). Packing keeps static shapes, as in JAX: the surviving
frames are compacted to the left by a scatter into a ``T + 1`` buffer whose
last row takes the dropped ones, the labels are written at ``1 + P + n + 1``
of each row, and the prompts and frames reach the LLM as an embedding
overlay (``GPT2MultiHeadDecoder(embeds_overlay=..., overlay_mask=...)``).
The ``prompt_with_tokens`` variant feeds the deduplicated CTC hypothesis as
token ids through the LLM's own embedding instead.

State-dict keys: ``encoder.*`` (``models/whisper_ctc.py``), ``linear``,
``soft_prompt`` ((P + 1, n_embd); row 0 is the end prompt) and ``decoder.*``
(``models/gpt2_decoder.py``, without cross-attention). The model computes in
its ``dtype`` over whatever its parameters are held in.

``freeze_asr`` stops the gradient at the encoder's hidden states and logits.
``freeze_llm`` changes nothing, as in the JAX model, which leaves freezing to
an optimizer mask that no command-line entry point builds (ROADMAP.md
reference caveat (j)).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng
from huggingface_asr_tpu_torch.models.gpt2_decoder import (
    GPT2DecoderConfig,
    GPT2MultiHeadDecoder,
    init_decoder_from_scratch_,
    smoothed_cross_entropy,
)
from huggingface_asr_tpu_torch.models.whisper_ctc import (
    WhisperCTCConfig,
    WhisperEncoderForCTC,
    dense,
    init_whisper_from_scratch_,
)
from huggingface_asr_tpu_torch.ops.lengths import lengths_to_mask


@dataclasses.dataclass(frozen=True)
class LLMASRConfig:
    """Every field and default is the JAX package's."""

    encoder: WhisperCTCConfig = WhisperCTCConfig()
    decoder: GPT2DecoderConfig = GPT2DecoderConfig(add_cross_attention=False)
    number_of_prompt_tokens: int = 16
    ctc_weight: float = 0.0  # aux encoder CTC loss weight
    # feed the deduplicated CTC hypothesis TOKEN IDS through the LLM's own
    # embedding table instead of projected encoder frame embeddings
    prompt_with_tokens: bool = False
    freeze_asr: bool = False
    freeze_llm: bool = False

    @classmethod
    def from_dict(cls, d) -> "LLMASRConfig":
        """Nested ``encoder`` and ``decoder`` dicts (either may be absent: its
        defaults), as the JAX CLI reads ``--model_config`` and ``config.json``."""
        return cls(
            encoder=WhisperCTCConfig.from_dict(d.get("encoder", {})),
            decoder=GPT2DecoderConfig.from_dict(d.get("decoder", {})),
            **{k: v for k, v in d.items() if k not in ("encoder", "decoder")},
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


@dataclasses.dataclass
class LLMASROutput:
    loss: Optional[torch.Tensor]
    enc_loss: Optional[torch.Tensor]
    llm_logits: torch.Tensor
    encoder_logits: torch.Tensor
    asr_lengths: torch.Tensor  # surviving CTC frames per example
    token_plan: torch.Tensor  # (B, L_total) id layout fed to the LLM


class LLMASRModel(nn.Module):
    def __init__(self, config: LLMASRConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        dcfg = config.decoder
        self.encoder = WhisperEncoderForCTC(config.encoder)
        if not config.prompt_with_tokens:
            self.linear = nn.Linear(config.encoder.llm_dim, dcfg.n_embd)
        self.soft_prompt = nn.Parameter(torch.zeros(config.number_of_prompt_tokens + 1, dcfg.n_embd))
        # the JAX decoder creates no cross-attention when it is given no encoder state
        self.decoder = GPT2MultiHeadDecoder(dataclasses.replace(dcfg, add_cross_attention=False), dtype,
                                            param_dtype=torch.float32)

    def forward(self, input_features: torch.Tensor, input_lengths: torch.Tensor,
                labels: Optional[torch.Tensor] = None, label_lengths: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> LLMASROutput:
        """``labels`` (B, L): LLM-vocabulary ids, eos-terminated. ``rng``:
        the training forward's dropout stream (encoder and LLM)."""
        cfg, dcfg, dt = self.config, self.config.decoder, self.dtype
        P = cfg.number_of_prompt_tokens
        with_ctc = cfg.ctc_weight > 0.0 and labels is not None
        enc = self.encoder(input_features.to(dt), input_lengths, labels=labels if with_ctc else None,
                           label_lengths=label_lengths if with_ctc else None, rng=rng)
        enc_hidden, enc_logits = enc.hidden_states[-1], enc.logits
        if cfg.freeze_asr:
            enc_hidden, enc_logits = enc_hidden.detach(), enc_logits.detach()
        B, T, _ = enc_logits.shape
        dev = enc_logits.device

        # greedy CTC: blank-strip and dedup the surviving frames (reference :50-58)
        preds = enc_logits.argmax(dim=-1)
        valid_t = lengths_to_mask(enc.logit_lengths, T)
        prev = F.pad(preds[:, :-1], (1, 0), value=-1)
        keep = (preds != cfg.encoder.blank_token_id) & (preds != prev) & valid_t
        pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
        pos = torch.where(keep, pos, T)  # dropped frames land in the buffer's last row
        n_asr = keep.sum(dim=1).to(torch.int32)
        pad_id = dcfg.pad_token_id if dcfg.pad_token_id is not None else 0
        if cfg.prompt_with_tokens:
            tok_buf = torch.full((B, T + 1), pad_id, dtype=torch.int64, device=dev)
            asr_tok_buf = tok_buf.scatter_(1, pos, preds)[:, :T]
        else:
            frame_feats = dense(self.linear, enc_hidden)
            asr_buf = torch.zeros(B, T + 1, dcfg.n_embd, dtype=frame_feats.dtype, device=dev)
            asr_buf = asr_buf.scatter_(1, pos[..., None].expand(B, T, dcfg.n_embd), frame_feats)[:, :T]

        soft_prompt = self.soft_prompt.to(dt)
        prompts, end_prompt = soft_prompt[1:], soft_prompt[0]
        L_lab = labels.shape[1] if labels is not None else 1
        L_total = 1 + P + T + 1 + L_lab

        # token-id plan: [bos][pad x P][pad x T][pad][labels at 1 + P + n + 1]
        tok_plan = torch.full((B, L_total), pad_id, dtype=torch.int64, device=dev)
        tok_plan[:, 0] = dcfg.bos_token_id
        if cfg.prompt_with_tokens:
            tok_plan[:, 1 + P:1 + P + T] = asr_tok_buf
        if labels is not None:
            cols = (2 + P + n_asr.to(torch.int64))[:, None] + torch.arange(L_lab, device=dev)[None, :]
            tok_plan.scatter_(1, cols, labels.to(torch.int64))

        # embedding overlay: prompts, ASR frames, end prompt
        overlay = torch.zeros(B, L_total, dcfg.n_embd, dtype=dt, device=dev)
        overlay[:, 1:1 + P] = prompts[None]
        if not cfg.prompt_with_tokens:
            overlay[:, 1 + P:1 + P + T] = asr_buf.to(dt)
        pos_idx = torch.arange(L_total, device=dev)[None, :]
        end_pos = (1 + P + n_asr.to(torch.int64))[:, None]
        overlay = torch.where((pos_idx == end_pos)[..., None], end_prompt[None, None, :], overlay)
        if cfg.prompt_with_tokens:
            # only the prompts and the end prompt are overlaid; the hypothesis
            # tokens embed through wte like ordinary text
            overlay_mask = ((pos_idx >= 1) & (pos_idx < 1 + P)) | (pos_idx == end_pos)
        else:
            overlay_mask = (pos_idx >= 1) & (pos_idx <= end_pos)  # prompts, frames, end prompt

        llm_logits = self.decoder(tok_plan, rng=rng, embeds_overlay=overlay, overlay_mask=overlay_mask).logits
        # cfg.freeze_llm: nothing here (caveat (j))

        loss = None
        if labels is not None:
            # position i predicts tok_plan[i + 1]: the end-prompt position
            # predicts labels[0], the last counted one labels[len - 1]
            targets = tok_plan[:, 1:]
            tpos = torch.arange(L_total - 1, device=dev)[None, :]
            zone = (tpos >= end_pos) & (tpos < end_pos + label_lengths[:, None].to(torch.int64))
            loss = smoothed_cross_entropy(llm_logits[:, :-1], targets, zone.float(), dcfg.lsm_factor)
            if cfg.ctc_weight > 0.0 and enc.loss is not None:
                loss = loss + cfg.ctc_weight * enc.loss
        return LLMASROutput(loss=loss, enc_loss=enc.loss, llm_logits=llm_logits, encoder_logits=enc.logits,
                            asr_lengths=n_asr, token_plan=tok_plan)


@torch.no_grad()
def llm_asr_greedy_decode(model: LLMASRModel, input_features: torch.Tensor, input_lengths: torch.Tensor,
                          max_len: int = 48) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy generation from the LLM over the soft-prompt + frame prefix
    (reference local_utils.py do_evaluate drives HF ``generate`` on the LLM).

    The LLM is causal, so the logit at ``end_pos + j`` depends only on the
    prefix and labels[0..j-1]: a fixed-shape label buffer re-run through the
    whole model once a token gives exact greedy decoding without a KV cache,
    as the JAX function does. ``max_len`` full forwards: an evaluation path,
    not a serving one.

    Returns (tokens (B, max_len) int32, lengths (B,) int32, cut at the first eos)."""
    dcfg = model.config.decoder
    pad_id = dcfg.pad_token_id if dcfg.pad_token_id is not None else 0
    B = input_features.shape[0]
    P = model.config.number_of_prompt_tokens
    dev = input_features.device
    buf = torch.full((B, max_len), pad_id, dtype=torch.int64, device=dev)
    full = torch.full((B,), max_len, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    for j in range(max_len):
        out = model(input_features, input_lengths, labels=buf, label_lengths=full)
        end_pos = 1 + P + out.asr_lengths.to(torch.int64)  # the position whose logit predicts labels[0]
        buf[:, j] = out.llm_logits[rows, end_pos + j].argmax(dim=-1)
    seen_eos = torch.cumsum((buf == dcfg.eos_token_id).to(torch.int32), dim=1) > 0
    return buf.to(torch.int32), (~seen_eos).sum(dim=1).to(torch.int32)


@torch.no_grad()
def init_llm_asr_from_scratch_(model: LLMASRModel, generator: torch.Generator) -> LLMASRModel:
    """The JAX init's distributions: the encoder, ``linear`` and the soft
    prompts as the Flax defaults draw them (``soft_prompt`` ~ N(0, 0.02^2)),
    then the decoder as ``init_decoder_from_scratch_`` does."""
    init_whisper_from_scratch_(model, generator, normal_002=("soft_prompt",), skip=("decoder.",))
    init_decoder_from_scratch_(model.decoder, generator)
    return model
