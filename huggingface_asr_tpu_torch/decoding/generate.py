"""Generation for the joint CTC/attention model
(counterpart of ``huggingface_asr_tpu/decoding/generate.py``; ``generate_whisper``
waits for the Whisper slice).

The encoder runs once; its CTC log-probs feed the prefix scorer; each
decoder layer's cross-attention K/V are written once from the unexpanded
encoder state and shared by the beams; the KV-cached decoder (and an
optional shallow-fusion LM, a decoder without cross-attention stepped with
its own cache) drives ``joint_beam_search``.

The encoder route: on CUDA tensors, where ``fused_encoder_refusal`` takes the
encoder config, the kernel path ``ctc_infer(..., return_hidden=True)`` (K2 and
the K1 layers), with ``enc_to_dec_proj`` applied in the model dtype; otherwise
the plain ``encode``.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig, joint_beam_search
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer, fused_encoder_refusal
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2MultiHeadDecoder
from huggingface_asr_tpu_torch.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder


def _expand_beams(x: torch.Tensor, num_beams: int) -> torch.Tensor:
    """(B, ...) -> (B*W, ...), each row repeated W times in place."""
    return x.repeat_interleave(num_beams, dim=0)


def build_decoder_step(decoder: GPT2MultiHeadDecoder, batch_beams: int, max_length: int,
                       kv_hidden: Optional[torch.Tensor] = None, kv_lengths: Optional[torch.Tensor] = None):
    """(step_fn, init_cache) for ``joint_beam_search`` over ``batch_beams`` rows.

    With ``kv_hidden`` (B, S, D), the unexpanded encoder state, each layer's
    cross-attention K/V are written once into the cache and read by every
    step with ``kv_lengths`` (B,); without it (an LM) there is no
    cross-attention."""
    device = next(decoder.parameters()).device
    cache = decoder.init_cache(batch_beams, max_length, device)
    if kv_hidden is not None:
        decoder.write_cross_kv(cache, kv_hidden)

    def step(cache, tokens, positions):
        out = decoder(tokens, encoder_lengths=kv_lengths, position_offset=positions, cache=cache)
        return out.logits[:, -1, :], cache

    return step, cache


def generate_joint(
    model: JointCTCAttentionEncoderDecoder,
    input_features: torch.Tensor,
    input_lengths: torch.Tensor,
    config: BeamSearchConfig,
    lm: Optional[GPT2MultiHeadDecoder] = None,
    fused_encoder: Union[bool, str] = "auto",
    fused: Optional[FusedCTC] = None,
    hook: Optional[Callable[..., None]] = None,
):
    """Encoder once, then the joint beam search.

    ``fused_encoder``: "auto" takes the kernel path on CUDA tensors where the
    encoder config and the model dtype pass ``fused_encoder_refusal``; True
    requires it (raises with the reason otherwise; on CPU tensors the
    kernels' plain versions run); False keeps the plain encoder. ``fused``:
    the encoder's folded kernel operands, where the caller keeps them (they
    are folded here otherwise). ``lm``: a shallow-fusion LM that computes in
    the model's dtype, used where ``config.lm_weight`` is not 0. ``hook`` is
    called with "encoder" before the encoder, with the beam search's marks
    during it, and with "end" after it.

    Returns (sequences (B, W, L), scores (B, W)) (and the components dict with
    ``config.return_components``)."""
    cfg = model.config
    B, W = input_features.shape[0], config.num_beams
    mark = hook or (lambda name, alive=None: None)

    refusal = fused_encoder_refusal(cfg.encoder, model.dtype)
    use_fused = fused_encoder
    if use_fused == "auto":
        use_fused = input_features.is_cuda and refusal is None
    elif use_fused and refusal is not None:
        raise ValueError(f"fused_encoder=True but the kernel path does not take this encoder: {refusal}")

    mark("encoder")
    if use_fused:
        fused = fused or FusedCTC(model.encoder, input_features.device)
        enc, hidden = ctc_infer(fused, input_features, input_lengths, return_hidden=True)
        cross_hidden = model.project(hidden)
    else:
        enc, cross_hidden = model.encode(input_features, input_lengths)
    ctc_log_probs = F.log_softmax(enc.logits.float(), dim=-1)

    decoder_step, init_cache = build_decoder_step(model.decoder, B * W, config.max_length,
                                                  cross_hidden, enc.logit_lengths)
    lm_step = init_lm_cache = None
    if lm is not None and config.lm_weight != 0.0:
        lm_step, init_lm_cache = build_decoder_step(lm, B * W, config.max_length)

    out = joint_beam_search(
        decoder_step, init_cache, B, config,
        ctc_log_probs=ctc_log_probs if config.ctc_weight > 0 else None,
        ctc_lengths=enc.logit_lengths,
        lm_step=lm_step, init_lm_cache=init_lm_cache,
        vocab_size=cfg.decoder.vocab_size, hook=hook,
    )
    mark("end")
    return out
