"""Joint CTC + attention encoder-decoder (DeCRED / "ED") (counterpart of
``huggingface_asr_tpu/models/joint_ctc_aed.py``).

An E-Branchformer CTC encoder whose post-final-LayerNorm state feeds a GPT-2
multi-head decoder through cross-attention, with an encoder-to-decoder
projection where the widths differ. State-dict keys follow
``huggingface_asr_tpu/interop/export_hf.py::export_joint``: ``encoder.*``,
``decoder.*`` and ``enc_to_dec_proj``.

The forward with labels is the training objective,
``ctc_weight * L_ctc + (1 - ctc_weight) * L_dec``: the encoder's training
forward gives the CTC loss over the label rows as they are (special ids
included, blank last), through the training attention kernel where
``attention_impl`` selects it; the decoder is teacher-forced on
``shift_right(labels, decoder_start_token_id)`` against ``labels`` under
their length mask, attending to the encoder state within its lengths.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import (
    CTCOutput,
    DropoutRng,
    EBranchformerForCTC,
    _lecun_normal,
    init_from_scratch_,
)
from huggingface_asr_tpu_torch.models.gpt2_decoder import (
    GPT2DecoderConfig,
    GPT2MultiHeadDecoder,
    init_decoder_from_scratch_,
)
from huggingface_asr_tpu_torch.ops.lengths import lengths_to_mask


@dataclasses.dataclass(frozen=True)
class JointCTCAttentionConfig:
    encoder: EBranchformerConfig = EBranchformerConfig()
    decoder: GPT2DecoderConfig = GPT2DecoderConfig()
    ctc_weight: float = 0.3
    shared_lm_head: bool = False
    decoder_start_token_id: int = 0
    pad_token_id: int = 3

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "JointCTCAttentionConfig":
        """Nested ``encoder`` and ``decoder`` dicts, as ``configs/decred_*.json``
        and the JAX package's checkpoint ``config.json`` hold them."""
        return cls(
            encoder=EBranchformerConfig.from_dict(d["encoder"]),
            decoder=GPT2DecoderConfig.from_dict(d["decoder"]),
            **{k: v for k, v in d.items() if k not in ("encoder", "decoder")},
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


@dataclasses.dataclass
class JointOutput:
    loss: Optional[torch.Tensor]
    enc_loss: Optional[torch.Tensor]
    dec_loss: Optional[torch.Tensor]
    logits: torch.Tensor  # decoder logits
    encoder_logits: torch.Tensor  # CTC logits (for joint decoding)
    encoder_hidden: torch.Tensor
    encoder_lengths: torch.Tensor


def shift_right(labels: torch.Tensor, start_id: int) -> torch.Tensor:
    """[y0..y_{L-1}] -> [start, y0..y_{L-2}]."""
    return torch.cat([torch.full_like(labels[:, :1], start_id), labels[:, :-1]], dim=1)


class JointCTCAttentionEncoderDecoder(nn.Module):
    """``dtype`` is the compute dtype of both halves; ``param_dtype`` where
    the decoder holds its weights (default ``dtype``, the serving layout; a
    trainer's model holds fp32). The encoder casts its parameters at each use
    whatever they are held in."""

    def __init__(self, config: JointCTCAttentionConfig, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.encoder = EBranchformerForCTC(config.encoder)
        self.decoder = GPT2MultiHeadDecoder(config.decoder, dtype, param_dtype)
        if config.encoder.hidden_size != config.decoder.n_embd:
            self.enc_to_dec_proj = nn.Linear(config.encoder.hidden_size, config.decoder.n_embd)
        else:
            self.enc_to_dec_proj = None

    def project(self, hidden: torch.Tensor) -> torch.Tensor:
        """The encoder state in the decoder's width, in the model dtype."""
        hidden = hidden.to(self.dtype)
        if self.enc_to_dec_proj is None:
            return hidden
        w = self.enc_to_dec_proj
        return hidden @ w.weight.to(self.dtype).t() + w.bias.to(self.dtype)

    def encode(self, input_features: torch.Tensor, input_lengths: Optional[torch.Tensor] = None,
               labels: Optional[torch.Tensor] = None, label_lengths: Optional[torch.Tensor] = None,
               rng: Optional[DropoutRng] = None) -> Tuple[CTCOutput, torch.Tensor]:
        """(CTC output, the projected post-final-LayerNorm state for
        cross-attention); with ``labels`` the output carries the CTC loss,
        with ``rng`` the encoder's training forward runs."""
        enc = self.encoder(input_features.to(self.dtype), input_lengths, labels=labels,
                           label_lengths=label_lengths, rng=rng, output_hidden_states=True)
        return enc, self.project(enc.hidden_states[-1])

    def decode_step(self, input_ids, cache, encoder_lengths, position_offset=None):
        """One incremental decoder step; logits (B, T, V) for the given tokens."""
        return self.decoder(input_ids, encoder_lengths=encoder_lengths, position_offset=position_offset,
                            cache=cache).logits


    def forward(self, input_features: torch.Tensor, input_lengths: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, label_lengths: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> JointOutput:
        """With ``labels`` (B, L) and ``label_lengths`` (B,): the joint loss
        and its two parts. Without: the decoder's logits for the start token
        alone. ``rng``: the training forward's dropout stream (both halves)."""
        cfg = self.config
        enc, cross_hidden = self.encode(input_features, input_lengths, labels, label_lengths, rng)
        loss = enc_loss = dec_loss = None
        if labels is not None:
            dec = self.decoder(shift_right(labels, cfg.decoder_start_token_id), cross_hidden, enc.logit_lengths,
                               labels=labels, label_mask=lengths_to_mask(label_lengths, labels.shape[1]), rng=rng)
            enc_loss, dec_loss = enc.loss, dec.loss
            loss = cfg.ctc_weight * enc_loss + (1.0 - cfg.ctc_weight) * dec_loss
        else:
            start = torch.full((input_features.shape[0], 1), cfg.decoder_start_token_id, dtype=torch.int64,
                               device=input_features.device)
            dec = self.decoder(start, cross_hidden, enc.logit_lengths, rng=rng)
        return JointOutput(loss=loss, enc_loss=enc_loss, dec_loss=dec_loss, logits=dec.logits,
                           encoder_logits=enc.logits, encoder_hidden=cross_hidden,
                           encoder_lengths=enc.logit_lengths)


@torch.no_grad()
def init_joint_from_scratch_(model: JointCTCAttentionEncoderDecoder,
                             generator: torch.Generator) -> JointCTCAttentionEncoderDecoder:
    """The distributions of the JAX package's ``JointCTCAttentionEncoderDecoder.init``
    for a model trained from scratch (``cli/train_aed.py`` when nothing is
    loaded): the encoder as ``init_from_scratch_`` draws it, then the decoder
    as ``init_decoder_from_scratch_`` does, then ``enc_to_dec_proj`` with
    Flax's Dense default (lecun_normal, bias 0), all from ``generator``."""
    init_from_scratch_(model.encoder, generator)
    init_decoder_from_scratch_(model.decoder, generator)
    if model.enc_to_dec_proj is not None:
        w = model.enc_to_dec_proj.weight
        w.copy_(_lecun_normal(w.shape, w.shape[1], generator))
        model.enc_to_dec_proj.bias.zero_()
    return model
