"""Generation for the joint CTC/attention model and the Whisper seq2seq
model (counterpart of ``huggingface_asr_tpu/decoding/generate.py``).

The encoder runs once; its CTC log-probs feed the prefix scorer; each
decoder layer's cross-attention K/V are written once from the unexpanded
encoder state and shared by the beams; the KV-cached decoder (and an
optional shallow-fusion LM, a decoder without cross-attention stepped with
its own cache) drives ``joint_beam_search``.

The encoder route: on CUDA tensors, where ``fused_encoder_refusal`` takes the
encoder config, the kernel path ``ctc_infer(..., return_hidden=True)`` (K2 and
the K1 layers), with ``enc_to_dec_proj`` applied in the model dtype; otherwise
the plain ``encode``.

``generate_whisper`` runs the Whisper encoder once and the same beam search
with attention scores alone (``ctc_weight=0``), Whisper's generation
specials applied to each step's logits (``build_whisper_decoder_step``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

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


NEG_INF_GEN = -1.0e9


def build_whisper_decoder_step(
    model,
    batch_beams: int,
    max_length: int,
    kv_hidden: torch.Tensor,
    kv_lengths: torch.Tensor,
    forced_decoder_ids: Optional[Sequence[Tuple[int, int]]] = None,
    suppress_tokens: Optional[Sequence[int]] = None,
    begin_suppress_tokens: Optional[Sequence[int]] = None,
):
    """(step_fn, init_cache) for the Whisper beam search over ``batch_beams``
    rows, the cross-attention K/V written once from ``kv_hidden`` (B, S, D),
    the unexpanded encoder state, and read with ``kv_lengths`` (B,).

    Whisper's generation specials (the reference gets them through HF
    generate and handle_whisper_generation_config, model_utils.py:248-261)
    transform each step's logits, as the JAX step does:

    - ``suppress_tokens`` are set to ``NEG_INF_GEN``;
    - ``begin_suppress_tokens`` get ``NEG_INF_GEN`` added at the first
      generated position only;
    - ``forced_decoder_ids`` ((position, token) pairs) are indexed from
      generation position 1, position 0 being the start token: at step
      ``p - 1`` every logit but the forced token's gets ``NEG_INF_GEN`` added.
    """
    device = kv_hidden.device
    cache = model.init_cache(batch_beams, max_length, device)
    model.write_cross_kv(cache, kv_hidden)
    forced_by_pos = {p - 1: t for p, t in dict(forced_decoder_ids or ()).items()}
    suppress = torch.as_tensor(list(suppress_tokens), device=device) if suppress_tokens else None
    begin = torch.as_tensor(list(begin_suppress_tokens), device=device) if begin_suppress_tokens else None

    def step(cache, tokens, positions):
        logits = model.decode_step(tokens, positions, cache, kv_lengths)[:, -1, :]
        pos = positions[:1]  # every beam is at the same step; read on the device
        if suppress is not None:
            logits[:, suppress] = NEG_INF_GEN
        if begin is not None:
            sup = torch.where(pos == 0, NEG_INF_GEN, 0.0).to(logits.dtype)
            logits.index_add_(1, begin, sup.expand(logits.shape[0], begin.numel()))
        for p, tok in forced_by_pos.items():
            forced_row = torch.full_like(logits[:1], NEG_INF_GEN)
            forced_row[0, tok] = 0.0
            logits = torch.where(pos == p, logits + forced_row, logits)
        return logits, cache

    return step, cache


def generate_whisper(
    model,
    input_features: torch.Tensor,
    input_lengths: torch.Tensor,
    config: BeamSearchConfig,
    forced_decoder_ids: Optional[Sequence[Tuple[int, int]]] = None,
    suppress_tokens: Optional[Sequence[int]] = None,
    begin_suppress_tokens: Optional[Sequence[int]] = None,
    hook: Optional[Callable[..., None]] = None,
):
    """Whisper AED beam search (``models/whisper_seq2seq.py``): the encoder
    once, then ``joint_beam_search`` on attention scores alone (pass
    ``ctc_weight=0``). Returns (sequences (B, W, L), scores (B, W)), as
    ``generate_joint`` does."""
    B = input_features.shape[0]
    mark = hook or (lambda name, alive=None: None)
    mark("encoder")
    enc_hidden, enc_lengths = model.encode(input_features, input_lengths)
    step, init_cache = build_whisper_decoder_step(
        model, B * config.num_beams, config.max_length, enc_hidden, enc_lengths,
        forced_decoder_ids=forced_decoder_ids, suppress_tokens=suppress_tokens,
        begin_suppress_tokens=begin_suppress_tokens)
    out = joint_beam_search(step, init_cache, B, config, vocab_size=model.config.vocab_size, hook=hook)
    mark("end")
    return out
