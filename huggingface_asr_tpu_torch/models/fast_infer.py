"""Fused CTC inference path (counterpart of ``huggingface_asr_tpu/models/fast_infer.py``).

``ctc_infer(fused, features, lengths)`` is the functional equivalent of
``EBranchformerForCTC(features, lengths)`` in bf16: the conv subsampler
(K2, ``kernels/subsample.py``), then every encoder layer as the K1 sequence
(``kernels/layer.py``), then the final LayerNorm and the two CTC heads as
plain tensor code — the JAX path computes those outside any kernel too.
On CUDA tensors the kernels run; on CPU tensors their plain versions.

Where K2 does not take the model's front end (any conv_dim other than
(256, 256), as in the 176-wide configs, or a gated front end), the model's own
feature extractor and feature projection run in bf16 instead, as the JAX path
runs its Flax modules, and the K1 layers follow as before. A model with
``csgu_use_linear_after_conv`` runs K1's two CSGU-linear pieces (the ungated
conv and the GEMM's gate epilogue) in place of the CSGU conv.

``FusedCTC`` holds the folded kernel operands. They are folded once, from a
loaded ``EBranchformerForCTC`` onto the target device; the relative-position
tables are built once per padded length and cached. It also holds the numeric
profile (``kernels/layer.py::PROFILES``), which ``ctc_infer`` passes to every
piece: ``"exact"`` (the default) or ``"serving"``, the JAX package's serving
profile (the A&S 7.1.27 GELU in K2 and K1, the bf16-probability softmax
normaliser in K1's attention).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from huggingface_asr_tpu_torch.kernels.attention import HEAD_WIDTHS, ROT_MAX, head_width
from huggingface_asr_tpu_torch.kernels.layer import (
    ACT_CODES,
    DWCONV_CSGU_ROW_C,
    DWCONV_MAX_C,
    check_profile,
    dwconv_channels_ok,
    ebranchformer_layer,
    ebranchformer_layer_plain,
    fold_layer_weights,
    rel_attention_width_ok,
    relpos_kernel_tables,
    rot_width,
)
from huggingface_asr_tpu_torch.kernels.mel import mel_bins_refusal
from huggingface_asr_tpu_torch.kernels.subsample import (
    conv_subsample,
    conv_subsample_plain,
    fits_subsample_kernel,
    fold_subsample_weights,
)
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import (
    CTCOutput,
    EBranchformerForCTC,
    feat_extract_output_frames,
    feat_extract_output_lengths,
)
from huggingface_asr_tpu_torch.ops.lengths import lengths_to_mask
from huggingface_asr_tpu_torch.utils.device import resolve_device


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def fused_encoder_refusal(cfg: EBranchformerConfig, dtype: torch.dtype, *, log_mel: bool = False) -> Optional[str]:
    """The first condition of the fused path that ``cfg`` and ``dtype`` fail,
    as a sentence for the user, or None where the fused path takes them: what
    the JAX package's ``fused_encoder_ok`` admits, within the kernels' limits.
    ``log_mel``: the caller also runs the log-mel and CMVN kernels in front of
    the encoder (the CTC pipeline does; the AED route keeps the plain front
    end, and the subsampler falls back to the model's own where it does not
    fit), so their bin limit applies too, and the bf16 kernel's table of
    the bank that front end builds (``kernels/mel.py::mel_bins_refusal``)."""
    mel_refusal = mel_bins_refusal(cfg.num_fbanks) if log_mel else None
    checks = (
        (cfg.position_embeddings_type == "relative",
         f"position_embeddings_type is {cfg.position_embeddings_type!r}, not 'relative'"),
        (not cfg.is_causal, "the model is causal"),
        (not cfg.finetune_with_layer_mixing, "finetune_with_layer_mixing is set"),
        (not cfg.finetune_with_additional_layer, "finetune_with_additional_layer is set"),
        (cfg.use_macaron_ff, "use_macaron_ff is off"),
        (cfg.hidden_act in ACT_CODES, f"hidden_act {cfg.hidden_act!r} has no kernel form"),
        (cfg.csgu_activation in ACT_CODES, f"csgu_activation {cfg.csgu_activation!r} has no kernel form"),
        (head_width(cfg.head_size) is not None,
         f"head size {cfg.head_size} (the attention kernels take head sizes of at most {HEAD_WIDTHS[-1]})"),
        (cfg.hidden_size % 8 == 0 and cfg.intermediate_size % 16 == 0,
         f"hidden_size {cfg.hidden_size}, intermediate_size {cfg.intermediate_size} (the GEMM kernel takes "
         f"multiples of 8 columns)"),
        (rel_attention_width_ok(rot_width(cfg.hidden_size)),
         f"hidden_size {cfg.hidden_size} (the attention kernels hold q_rot rows of at most {ROT_MAX} columns in "
         f"shared memory)"),
        (dwconv_channels_ok(0, cfg.intermediate_size // 2) and dwconv_channels_ok(1, 2 * cfg.hidden_size),
         f"intermediate_size {cfg.intermediate_size}, hidden_size {cfg.hidden_size} (the depthwise conv kernels "
         f"take at most {DWCONV_MAX_C[0]} CSGU channels, in whole 128-channel slices past {DWCONV_CSGU_ROW_C}, "
         f"and {DWCONV_MAX_C[1]} merge channels)"),
        (mel_refusal is None, f"num_fbanks {cfg.num_fbanks} {mel_refusal}"),
        (dtype == torch.bfloat16, f"dtype {dtype} (the kernels run bfloat16)"),
    )
    return next((reason for ok, reason in checks if not ok), None)


def fused_encoder_ok(cfg: EBranchformerConfig, dtype: torch.dtype) -> bool:
    """Static gate for the fused path (single source of truth for the pipeline)."""
    return fused_encoder_refusal(cfg, dtype) is None


class FusedCTC:
    """Folded kernel operands of one ``EBranchformerForCTC`` on one device,
    and the numeric profile its pieces run."""

    def __init__(self, model: EBranchformerForCTC, device="cuda", profile: str = "exact"):
        cfg = model.config
        if not fused_encoder_ok(cfg, torch.bfloat16):
            raise ValueError("model config is outside the fused path's support")
        self.config = cfg
        self.profile = check_profile(profile)
        self.device = resolve_device(device)
        w2v = model.wav2vec2
        with torch.no_grad():
            # K2's folded operands, or (where K2 does not take the front end)
            # the model's own two front-end modules
            self.subsample = fold_subsample_weights(w2v, cfg, self.device) if fits_subsample_kernel(cfg) else None
            self.front_end = None if self.subsample is not None else (
                copy.deepcopy(w2v.feature_extractor).to(self.device),
                copy.deepcopy(w2v.feature_projection).to(self.device))
            self.layers = [fold_layer_weights(l, cfg, self.device) for l in w2v.encoder.layers]
            ln = w2v.encoder.layer_norm
            self.ln_g = ln.weight.detach().float().to(self.device)
            self.ln_b = ln.bias.detach().float().to(self.device)
            # CTC heads: [vocab | blank] as one (D, V+1) matrix of bf16 values.
            w = torch.cat([model.lm_head.weight, model.blank_projection.weight]).detach()
            self.heads_w = w.t().contiguous().to(torch.bfloat16).float().to(self.device)
            b = torch.cat([model.lm_head.bias, model.blank_projection.bias]).detach()
            self.heads_b = b.float().to(self.device)
        self._tables: Dict[int, Dict[str, torch.Tensor]] = {}

    def tables(self, T: int) -> Dict[str, torch.Tensor]:
        if T not in self._tables:
            self._tables[T] = relpos_kernel_tables(T, self.config.hidden_size, self.device)
        return self._tables[T]


def ctc_infer(fused: FusedCTC, input_features: torch.Tensor, input_lengths: torch.Tensor,
              *, plain: bool = False, return_hidden: bool = False):
    """(B, T_in, num_fbanks) features + (B,) frame lengths -> bf16 CTC logits
    (B, T, V+1) and the CTC decode lengths. ``plain=True`` runs every
    kernel's plain version, on any device. Every piece runs ``fused.profile``.
    ``return_hidden=True`` returns
    ``(output, hidden)`` with the post-final-LayerNorm bf16 hidden states
    (B, T, D), as ``ctc_infer_fused(..., return_hidden=True)`` does."""
    cfg = fused.config
    T = int(feat_extract_output_frames(cfg, input_features.shape[1]))
    T_pad = _round_up(T, 8)
    layer = ebranchformer_layer_plain if plain else ebranchformer_layer
    if fused.subsample is not None:
        subsample = conv_subsample_plain if plain else conv_subsample
        hidden = subsample(input_features, fused.subsample, cfg, T_pad, fused.profile)
    else:
        # the model's conv front end and feature projection in bf16 (no
        # kernel of its own), padded with zero frames to T_pad
        extractor, projection = fused.front_end
        with torch.no_grad():
            hidden = projection(extractor(input_features.to(torch.bfloat16)))[0]
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, T_pad - hidden.shape[1]))

    # Encoder masking uses the padded-conv frame count; the RETURNED lengths
    # the reference's unpadded formula (models/ebranchformer.py).
    input_lengths = input_lengths.to(torch.int64)
    enc_lengths = torch.clamp(feat_extract_output_frames(cfg, input_lengths), 0, T)
    out_lengths = torch.clamp(feat_extract_output_lengths(cfg, input_lengths), 0, T)
    mask = lengths_to_mask(enc_lengths, T_pad)
    # Rows past each length are zeroed once here; the layers' convs mask only
    # rows >= T (the batch's unpadded frame count), as the TPU path does.
    x = torch.where(mask[..., None], hidden, 0.0).to(torch.bfloat16).contiguous()
    enc_lengths = enc_lengths.to(torch.int32)
    tables = fused.tables(T_pad)
    for w in fused.layers:
        x = layer(x, enc_lengths, w, cfg, T, tables, fused.profile)

    # final encoder LayerNorm (two-pass variance, as fast_infer.py computes it)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    x = ((xf - mu) * torch.rsqrt(var + cfg.layer_norm_eps) * fused.ln_g + fused.ln_b)
    x = x.to(torch.bfloat16)[:, :T]
    logits = (x.float() @ fused.heads_w + fused.heads_b).to(torch.bfloat16)
    out = CTCOutput(logits=logits, logit_lengths=out_lengths.to(torch.int32))
    return (out, x) if return_hidden else out
