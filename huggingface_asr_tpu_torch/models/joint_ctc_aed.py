"""Joint CTC + attention encoder-decoder (DeCRED / "ED"), inference half
(counterpart of ``huggingface_asr_tpu/models/joint_ctc_aed.py``).

An E-Branchformer CTC encoder whose post-final-LayerNorm state feeds a GPT-2
multi-head decoder through cross-attention, with an encoder-to-decoder
projection where the widths differ. State-dict keys follow
``huggingface_asr_tpu/interop/export_hf.py::export_joint``: ``encoder.*``,
``decoder.*`` and ``enc_to_dec_proj``.

The training loss (``ctc_weight * L_ctc + (1 - ctc_weight) * L_dec``) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import CTCOutput, EBranchformerForCTC
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig, GPT2MultiHeadDecoder


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


class JointCTCAttentionEncoderDecoder(nn.Module):
    """``dtype`` is the compute dtype of both halves."""

    def __init__(self, config: JointCTCAttentionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.encoder = EBranchformerForCTC(config.encoder)
        self.decoder = GPT2MultiHeadDecoder(config.decoder, dtype)
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

    def encode(self, input_features: torch.Tensor,
               input_lengths: Optional[torch.Tensor] = None) -> Tuple[CTCOutput, torch.Tensor]:
        """(CTC output, the projected post-final-LayerNorm state for cross-attention)."""
        enc = self.encoder(input_features.to(self.dtype), input_lengths, output_hidden_states=True)
        return enc, self.project(enc.hidden_states[-1])

    def decode_step(self, input_ids, cache, encoder_lengths, position_offset=None):
        """One incremental decoder step; logits (B, T, V) for the given tokens."""
        return self.decoder(input_ids, encoder_lengths=encoder_lengths, position_offset=position_offset,
                            cache=cache).logits

