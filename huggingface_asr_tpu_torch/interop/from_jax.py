"""Flax parameter tree -> this package's state dict.

Mirror of ``huggingface_asr_tpu/interop/export_hf.py::export_ebranchformer_ctc``
written with numpy and torch only: the tree comes in as nested dicts of numpy
arrays, and the keys that come out are the reference HF keys that
``EBranchformerForCTC`` (``models/ebranchformer.py``) is named after, so
``load_state_dict(strict=True)`` accepts the result.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _conv2d(w) -> np.ndarray:
    """flax (kh, kw, I, O) -> torch (O, I, kh, kw)."""
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _conv1d(w) -> np.ndarray:
    """flax (k, I/g, O) -> torch (O, I/g, k)."""
    return np.ascontiguousarray(np.asarray(w).transpose(2, 1, 0))


def _dense(out, prefix, p):
    out[f"{prefix}.weight"] = _t(p["kernel"])
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _ln(out, prefix, p):
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def state_dict_from_flax(
    tree: Mapping[str, Any], cfg: EBranchformerConfig
) -> Dict[str, torch.Tensor]:
    """Flax ``EBranchformerForCTC`` params (nested dicts of arrays) -> float32
    torch state dict keyed like the reference ``Wav2Vec2EBranchformerForCTC``."""
    sd: Dict[str, np.ndarray] = {}
    w2v = tree["wav2vec2"]
    fe = w2v["feature_extractor"]
    for i in range(len(cfg.conv_dim)):
        if f"gate_{i}" in fe:
            raise NotImplementedError("gated conv front ends are not ported yet")
        base = f"wav2vec2.feature_extractor.conv.{i}.0"
        sd[f"{base}.conv.weight"] = _conv2d(fe[f"conv_{i}"]["kernel"])
        sd[f"{base}.conv.bias"] = np.asarray(fe[f"conv_{i}"]["bias"])
    _dense(sd, "wav2vec2.feature_extractor.out", fe["out"])
    fp = w2v["feature_projection"]
    _ln(sd, "wav2vec2.feature_projection.layer_norm", fp["layer_norm"])
    _dense(sd, "wav2vec2.feature_projection.projection", fp["projection"])

    enc = w2v["encoder"]
    _ln(sd, "wav2vec2.encoder.layer_norm", enc["layer_norm"])
    for i in range(cfg.num_hidden_layers):
        L = enc[f"layers_{i}"]
        p = f"wav2vec2.encoder.layers.{i}"
        if cfg.use_macaron_ff:
            for ff in ("ff1", "ff2"):
                _ln(sd, f"{p}.{ff}.0", L[f"{ff}_layer_norm"])
                _dense(sd, f"{p}.{ff}.1.intermediate_dense", L[ff]["intermediate_dense"])
                _dense(sd, f"{p}.{ff}.1.output_dense", L[ff]["output_dense"])
        _ln(sd, f"{p}.self_attn_layer_norm", L["self_attn_layer_norm"])
        attn = L["self_attn"]
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            _dense(sd, f"{p}.self_attn.{name}", attn[name])
        if "linear_pos" in attn:
            sd[f"{p}.self_attn.linear_pos.weight"] = _t(attn["linear_pos"]["kernel"])
            sd[f"{p}.self_attn.pos_bias_u"] = np.asarray(attn["pos_bias_u"])
            sd[f"{p}.self_attn.pos_bias_v"] = np.asarray(attn["pos_bias_v"])
        _ln(sd, f"{p}.cgMLP_layer_norm", L["cgMLP_layer_norm"])
        cg = L["cgMLP"]
        _dense(sd, f"{p}.cgMLP.channel_proj1.0", cg["channel_proj1"])
        _ln(sd, f"{p}.cgMLP.csgu.norm", cg["csgu"]["norm"])
        sd[f"{p}.cgMLP.csgu.conv.weight"] = _conv1d(cg["csgu"]["conv"]["kernel"])
        sd[f"{p}.cgMLP.csgu.conv.bias"] = np.asarray(cg["csgu"]["conv"]["bias"])
        if "linear" in cg["csgu"]:
            _dense(sd, f"{p}.cgMLP.csgu.linear", cg["csgu"]["linear"])
        _dense(sd, f"{p}.cgMLP.channel_proj2", cg["channel_proj2"])
        sd[f"{p}.depthwise_conv_fusion.weight"] = _conv1d(L["depthwise_conv_fusion"]["kernel"])
        sd[f"{p}.depthwise_conv_fusion.bias"] = np.asarray(L["depthwise_conv_fusion"]["bias"])
        _dense(sd, f"{p}.merge_proj", L["merge_proj"])
        _ln(sd, f"{p}.final_layer_norm", L["final_layer_norm"])

    _dense(sd, "lm_head", tree["lm_head"])
    _dense(sd, "blank_projection", tree["blank_projection"])
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
