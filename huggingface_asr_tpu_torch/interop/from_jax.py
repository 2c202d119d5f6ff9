"""Flax parameter tree <-> this package's state dict.

``state_dict_from_flax`` mirrors
``huggingface_asr_tpu/interop/export_hf.py::export_ebranchformer_ctc`` with
numpy and torch only: the tree comes in as nested dicts of numpy arrays, and
the keys that come out are the reference HF keys that ``EBranchformerForCTC``
(``models/ebranchformer.py``) is named after, so ``load_state_dict(strict=True)``
accepts the result. ``flax_tree_from_state_dict`` is its inverse (numpy out),
so gradients and trained weights can go back for comparison.

Both walk one table of (Flax path, state-dict key, layout change). The
decoder's table (``decoder_param_table``) mirrors ``export_gpt2_decoder``, the
joint model's (``joint_param_table``) ``export_joint``, BEST-RQ
pretraining's (``pretraining_param_table``) the tree of
``huggingface_asr_tpu/models/bestrq.py``: the encoder under ``wav2vec2``, one
``classifiers_{k}`` Dense a book, and the frozen quantizer in the ``buffers``
collection; and wav2vec2 pretraining's (``wav2vec2_param_table``) the tree of
``huggingface_asr_tpu/models/wav2vec2_ssl.py``: the encoder with
``masked_spec_embed``, the quantizer's ``codevectors`` and ``weight_proj``,
``project_hid`` and ``project_q``. Each has the same pair of functions.

The recipe families' tables mirror ``huggingface_asr_tpu/interop/hf_whisper.py``'s
names (HF Whisper's, and the reference extensions): the Whisper-encoder CTC
model (``whisper_ctc_param_table``), the Whisper seq2seq model
(``whisper_seq2seq_param_table``) and LLM-ASR (``llm_asr_param_table``: the
CTC encoder, ``linear``, ``soft_prompt`` and the decoder through
``decoder_param_table``, without cross-attention). The Whisper encoders'
sinusoid table, a buffer of the port's models that the Flax trees do not
hold, is added from the config.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Iterator, Mapping, Tuple

import numpy as np
import torch

from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig
from huggingface_asr_tpu_torch.models.whisper_ctc import _sinusoids

# layout change -> (axes Flax -> torch, axes torch -> Flax)
_AXES = {
    "same": (None, None),
    "dense": ((1, 0), (1, 0)),  # (in, out) <-> (out, in)
    "conv2d": ((3, 2, 0, 1), (2, 3, 1, 0)),  # (kh, kw, I, O) <-> (O, I, kh, kw)
    "conv1d": ((2, 1, 0), (2, 1, 0)),  # (k, I/g, O) <-> (O, I/g, k)
}

Entry = Tuple[Tuple[str, ...], str, str]


def _dense(path, key, bias=True) -> Iterator[Entry]:
    yield path + ("kernel",), f"{key}.weight", "dense"
    if bias:
        yield path + ("bias",), f"{key}.bias", "same"


def _ln(path, key) -> Iterator[Entry]:
    yield path + ("scale",), f"{key}.weight", "same"
    yield path + ("bias",), f"{key}.bias", "same"


def _conv(path, key, kind) -> Iterator[Entry]:
    yield path + ("kernel",), f"{key}.weight", kind
    yield path + ("bias",), f"{key}.bias", "same"


def _layer_entries(L: Tuple[str, ...], p: str, cfg: EBranchformerConfig) -> Iterator[Entry]:
    """One E-Branchformer layer at Flax path ``L`` and state-dict prefix ``p``."""
    if cfg.use_macaron_ff:
        for ff in ("ff1", "ff2"):
            yield from _ln(L + (f"{ff}_layer_norm",), f"{p}.{ff}.0")
            yield from _dense(L + (ff, "intermediate_dense"), f"{p}.{ff}.1.intermediate_dense")
            yield from _dense(L + (ff, "output_dense"), f"{p}.{ff}.1.output_dense")
    yield from _ln(L + ("self_attn_layer_norm",), f"{p}.self_attn_layer_norm")
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        yield from _dense(L + ("self_attn", name), f"{p}.self_attn.{name}")
    if cfg.position_embeddings_type == "relative":
        yield from _dense(L + ("self_attn", "linear_pos"), f"{p}.self_attn.linear_pos", bias=False)
        yield L + ("self_attn", "pos_bias_u"), f"{p}.self_attn.pos_bias_u", "same"
        yield L + ("self_attn", "pos_bias_v"), f"{p}.self_attn.pos_bias_v", "same"
    yield from _ln(L + ("cgMLP_layer_norm",), f"{p}.cgMLP_layer_norm")
    yield from _dense(L + ("cgMLP", "channel_proj1"), f"{p}.cgMLP.channel_proj1.0")
    yield from _ln(L + ("cgMLP", "csgu", "norm"), f"{p}.cgMLP.csgu.norm")
    yield from _conv(L + ("cgMLP", "csgu", "conv"), f"{p}.cgMLP.csgu.conv", "conv1d")
    if cfg.csgu_use_linear_after_conv:
        yield from _dense(L + ("cgMLP", "csgu", "linear"), f"{p}.cgMLP.csgu.linear")
    yield from _dense(L + ("cgMLP", "channel_proj2"), f"{p}.cgMLP.channel_proj2")
    yield from _conv(L + ("depthwise_conv_fusion",), f"{p}.depthwise_conv_fusion", "conv1d")
    yield from _dense(L + ("merge_proj",), f"{p}.merge_proj")
    yield from _ln(L + ("final_layer_norm",), f"{p}.final_layer_norm")


def param_table(cfg: EBranchformerConfig) -> Iterator[Entry]:
    """Every parameter of the CTC model as (Flax path, state-dict key, layout
    change), the BEST-RQ fine-tuning adapters included where the config sets
    them (``per_layer_weights``; ``additional_layer``, a layer's entries).
    A gated front end's convs are ``conv.{i}.0.conv.conv`` and its gate convs
    (Flax ``gate_{i}``) ``conv.{i}.0.conv.gate``, the reference's names."""
    w = ("wav2vec2",)
    gated = cfg.context_awareness_type not in (None, "none")
    for i in range(len(cfg.conv_dim)):
        fe, key = w + ("feature_extractor",), f"wav2vec2.feature_extractor.conv.{i}.0.conv"
        if gated:
            yield from _conv(fe + (f"conv_{i}",), f"{key}.conv", "conv2d")
            yield from _conv(fe + (f"gate_{i}",), f"{key}.gate", "conv2d")
        else:
            yield from _conv(fe + (f"conv_{i}",), key, "conv2d")
    yield from _dense(w + ("feature_extractor", "out"), "wav2vec2.feature_extractor.out")
    yield from _ln(w + ("feature_projection", "layer_norm"), "wav2vec2.feature_projection.layer_norm")
    yield from _dense(w + ("feature_projection", "projection"), "wav2vec2.feature_projection.projection")
    yield from _ln(w + ("encoder", "layer_norm"), "wav2vec2.encoder.layer_norm")
    for i in range(cfg.num_hidden_layers):
        yield from _layer_entries(w + ("encoder", f"layers_{i}"), f"wav2vec2.encoder.layers.{i}", cfg)
    if cfg.finetune_with_layer_mixing:
        yield ("per_layer_weights",), "per_layer_weights", "same"
    if cfg.finetune_with_additional_layer:
        yield from _layer_entries(("additional_layer",), "additional_layer", cfg)
    yield from _dense(("lm_head",), "lm_head")
    yield from _dense(("blank_projection",), "blank_projection")


def _moved(a: np.ndarray, axes) -> np.ndarray:
    return a if axes is None else np.ascontiguousarray(a.transpose(axes))


def decoder_param_table(cfg: GPT2DecoderConfig, tree: Mapping[str, Any]) -> Iterator[Entry]:
    """Every parameter of a GPT-2 (multi-head) decoder, as ``export_gpt2_decoder``
    writes it. GPT-2 ``Conv1D`` weights are (in, out) on both sides; the heads
    are dense. ``tree`` (Flax params, or None-valued stand-ins) decides the
    optional entries, as the export does: ``wpe``, the cross-attention, the
    heads, and ``lm_mixing`` under the names ``interop/hf_decred.py`` reads
    (``lm_mixing.weight`` / ``.bias`` for the "full" Linear, ``lm_mixing``
    for the "linear" and "scalar" parameters); the residual classifier is
    ``lm_head`` over the concatenated states."""
    yield ("wte", "embedding"), "transformer.wte.weight", "same"
    if "wpe" in tree:
        yield ("wpe",), "transformer.wpe.weight", "same"
    yield from _ln(("ln_f",), "transformer.ln_f")
    for i in range(cfg.n_layer):
        L, b = (f"h_{i}",), f"transformer.h.{i}"
        yield from _ln(L + ("ln_1",), f"{b}.ln_1")
        for name in ("c_attn", "c_proj"):
            yield from _conv(L + ("attn", name), f"{b}.attn.{name}", "same")
        if "crossattention" in tree[f"h_{i}"]:
            for name in ("q_attn", "c_attn", "c_proj"):
                yield from _conv(L + ("crossattention", name), f"{b}.crossattention.{name}", "same")
            yield from _ln(L + ("ln_cross_attn",), f"{b}.ln_cross_attn")
        yield from _ln(L + ("ln_2",), f"{b}.ln_2")
        yield from _conv(L + ("mlp_c_fc",), f"{b}.mlp.c_fc", "same")
        yield from _conv(L + ("mlp_c_proj",), f"{b}.mlp.c_proj", "same")
    if "lm_head" in tree:
        yield from _dense(("lm_head",), "lm_head", bias=False)
    for k in range(len(cfg.head_locations)):
        if f"additional_lm_heads_{k}" in tree:
            yield from _dense((f"additional_lm_heads_{k}",), f"additional_lm_heads.{k}", bias=False)
    if "lm_mixing" in tree:
        if cfg.mixing_mode == "full":
            yield from _dense(("lm_mixing",), "lm_mixing")
        else:  # "linear" (n, V) or "scalar" (n,): one parameter, the same layout on both sides
            yield ("lm_mixing",), "lm_mixing", "same"


def decoder_tree_shape(cfg: GPT2DecoderConfig) -> Dict[str, Any]:
    """The optional parts of a decoder's Flax tree that this package's
    ``GPT2MultiHeadDecoder(cfg)`` has, as the tree ``decoder_param_table`` reads."""
    tree: Dict[str, Any] = {f"h_{i}": {"crossattention": None} if cfg.add_cross_attention else {}
                            for i in range(cfg.n_layer)}
    if not cfg.pos_emb_fixed:
        tree["wpe"] = None
    if cfg.connected_residuals:  # the residual classifier's lm_head (over the concatenated states) alone
        tree["lm_head"] = None
        return tree
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = None
    if not cfg.tie_additional_weights:
        tree.update({f"additional_lm_heads_{k}": None for k in range(len(cfg.head_locations))})
    if cfg.mixing_mode is not None:
        tree["lm_mixing"] = None
    return tree


def _prefixed(entries: Iterable[Entry], path: Tuple[str, ...], key: str) -> Iterator[Entry]:
    for p, k, kind in entries:
        yield path + p, key + k, kind


def joint_param_table(enc: EBranchformerConfig, dec: GPT2DecoderConfig,
                      tree: Mapping[str, Any]) -> Iterator[Entry]:
    """Every parameter of the joint CTC/attention model, as ``export_joint`` writes it."""
    yield from _prefixed(param_table(enc), ("encoder",), "encoder.")
    yield from _prefixed(decoder_param_table(dec, tree["decoder"]), ("decoder",), "decoder.")
    if "enc_to_dec_proj" in tree:
        yield from _dense(("enc_to_dec_proj",), "enc_to_dec_proj")


def joint_tree_shape(enc: EBranchformerConfig, dec: GPT2DecoderConfig) -> Dict[str, Any]:
    tree: Dict[str, Any] = {"decoder": decoder_tree_shape(dec)}
    if enc.hidden_size != dec.n_embd:
        tree["enc_to_dec_proj"] = None
    return tree


def _to_state_dict(tree: Mapping[str, Any], table: Iterable[Entry]) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, key, kind in table:
        leaf = tree
        for name in path:
            leaf = leaf[name]
        sd[key] = torch.as_tensor(_moved(np.asarray(leaf, np.float32), _AXES[kind][0]))
    return sd


def _to_tree(sd: Mapping[str, Any], table: Iterable[Entry]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, key, kind in table:
        v = sd[key]
        a = v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = _moved(a, _AXES[kind][1])
    return tree


def state_dict_from_flax(
    tree: Mapping[str, Any], cfg: EBranchformerConfig
) -> Dict[str, torch.Tensor]:
    """Flax ``EBranchformerForCTC`` params (nested dicts of arrays) -> float32
    torch state dict keyed like the reference ``Wav2Vec2EBranchformerForCTC``."""
    return _to_state_dict(tree, param_table(cfg))


def flax_tree_from_state_dict(
    sd: Mapping[str, Any], cfg: EBranchformerConfig
) -> Dict[str, Any]:
    """The inverse of ``state_dict_from_flax``: a state dict (or any mapping
    keyed like one, e.g. gradients by parameter name) of tensors or arrays ->
    the Flax tree as nested dicts of float32 numpy arrays."""
    return _to_tree(sd, param_table(cfg))


def decoder_state_dict_from_flax(tree: Mapping[str, Any], cfg: GPT2DecoderConfig) -> Dict[str, torch.Tensor]:
    """Flax ``GPT2MultiHeadDecoder`` params -> float32 state dict of
    ``models/gpt2_decoder.py::GPT2MultiHeadDecoder`` (an LM as well: a
    decoder without cross-attention)."""
    return _to_state_dict(tree, decoder_param_table(cfg, tree))


def decoder_flax_tree_from_state_dict(sd: Mapping[str, Any], cfg: GPT2DecoderConfig) -> Dict[str, Any]:
    """The inverse of ``decoder_state_dict_from_flax``."""
    return _to_tree(sd, decoder_param_table(cfg, decoder_tree_shape(cfg)))


def joint_state_dict_from_flax(tree: Mapping[str, Any], enc: EBranchformerConfig,
                               dec: GPT2DecoderConfig) -> Dict[str, torch.Tensor]:
    """Flax ``JointCTCAttentionEncoderDecoder`` params -> float32 state dict of
    ``models/joint_ctc_aed.py::JointCTCAttentionEncoderDecoder``."""
    return _to_state_dict(tree, joint_param_table(enc, dec, tree))


def joint_flax_tree_from_state_dict(sd: Mapping[str, Any], enc: EBranchformerConfig,
                                    dec: GPT2DecoderConfig) -> Dict[str, Any]:
    """The inverse of ``joint_state_dict_from_flax``."""
    return _to_tree(sd, joint_param_table(enc, dec, joint_tree_shape(enc, dec)))


def pretraining_param_table(cfg: EBranchformerConfig) -> Iterator[Entry]:
    """Every parameter of ``BestRQForPreTraining``: the CTC model's encoder
    entries (``wav2vec2``) and one classifier a book."""
    yield from (e for e in param_table(cfg) if e[0][0] == "wav2vec2")
    for k in range(cfg.best_rq_num_books):
        yield from _dense((f"classifiers_{k}",), f"classifiers.{k}")


# the ``buffers`` collection of BEST-RQ pretraining: the frozen quantizer
_PRETRAINING_BUFFERS = ((("rpq", "P"), "rpq.P", "same"), (("rpq", "CB"), "rpq.CB", "same"))


def pretraining_state_dict_from_flax(variables: Mapping[str, Any], cfg: EBranchformerConfig) -> Dict[str, torch.Tensor]:
    """Flax ``BestRQForPreTraining`` variables (``{"params": ..., "buffers":
    ...}``, the buffers optional) -> float32 state dict of
    ``models/bestrq.py::BestRQForPreTraining`` (with ``rpq.P`` and ``rpq.CB``
    where the buffers are given)."""
    sd = _to_state_dict(variables["params"], pretraining_param_table(cfg))
    if "buffers" in variables:
        sd.update(_to_state_dict(variables["buffers"], _PRETRAINING_BUFFERS))
    return sd


def pretraining_flax_tree_from_state_dict(sd: Mapping[str, Any], cfg: EBranchformerConfig) -> Dict[str, Any]:
    """The inverse of ``pretraining_state_dict_from_flax``: ``{"params": ...}``,
    and ``"buffers"`` where ``sd`` holds the quantizer's. Gradients keyed by
    parameter name go back the same way."""
    out = {"params": _to_tree(sd, pretraining_param_table(cfg))}
    if "rpq.P" in sd:
        out["buffers"] = _to_tree(sd, _PRETRAINING_BUFFERS)
    return out


def wav2vec2_param_table(cfg: EBranchformerConfig) -> Iterator[Entry]:
    """Every parameter of ``Wav2Vec2ForPreTraining``: the CTC model's encoder
    entries, ``masked_spec_embed``, the quantizer and the two projections."""
    yield from (e for e in param_table(cfg) if e[0][0] == "wav2vec2")
    yield ("wav2vec2", "masked_spec_embed"), "wav2vec2.masked_spec_embed", "same"
    yield ("quantizer", "codevectors"), "quantizer.codevectors", "same"
    yield from _dense(("quantizer", "weight_proj"), "quantizer.weight_proj")
    yield from _dense(("project_hid",), "project_hid")
    yield from _dense(("project_q",), "project_q")


def wav2vec2_state_dict_from_flax(params: Mapping[str, Any], cfg: EBranchformerConfig) -> Dict[str, torch.Tensor]:
    """Flax ``Wav2Vec2ForPreTraining`` params -> float32 state dict of
    ``models/wav2vec2_ssl.py::Wav2Vec2ForPreTraining``."""
    return _to_state_dict(params, wav2vec2_param_table(cfg))


def wav2vec2_flax_tree_from_state_dict(sd: Mapping[str, Any], cfg: EBranchformerConfig) -> Dict[str, Any]:
    """The inverse of ``wav2vec2_state_dict_from_flax`` (gradients keyed by
    parameter name go back the same way)."""
    return _to_tree(sd, wav2vec2_param_table(cfg))


# ---------------------------------------------------------------- recipes

def _whisper_layer(L: Tuple[str, ...], p: str, cross: bool = False) -> Iterator[Entry]:
    """One Whisper layer at Flax path ``L``, state-dict prefix ``p`` (a
    decoder layer with ``cross``)."""
    def attn(name):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield from _dense(L + (name, proj), f"{p}.{name}.{proj}", bias=proj != "k_proj")

    yield from _ln(L + ("self_attn_layer_norm",), f"{p}.self_attn_layer_norm")
    yield from attn("self_attn")
    if cross:
        yield from _ln(L + ("encoder_attn_layer_norm",), f"{p}.encoder_attn_layer_norm")
        yield from attn("encoder_attn")
    yield from _ln(L + ("final_layer_norm",), f"{p}.final_layer_norm")
    yield from _dense(L + ("fc1",), f"{p}.fc1")
    yield from _dense(L + ("fc2",), f"{p}.fc2")


def _whisper_encoder(L: Tuple[str, ...], key: str, n_layers: int) -> Iterator[Entry]:
    for conv in ("conv1", "conv2"):
        yield from _conv(L + (conv,), f"{key}{conv}", "conv1d")
    for i in range(n_layers):
        yield from _whisper_layer(L + (f"layers_{i}",), f"{key}layers.{i}")
    yield from _ln(L + ("layer_norm",), f"{key}layer_norm")


def whisper_ctc_param_table(cfg) -> Iterator[Entry]:
    """Every parameter of ``WhisperEncoderForCTC`` (``models/whisper_ctc.py``);
    the Flax tree holds the encoder at its top."""
    yield from _whisper_encoder((), "encoder.", cfg.encoder_layers)
    yield from _dense(("dim_matching",), "dim_matching")
    yield from _whisper_layer(("additional_layer_1",), "additional_layer_1")
    if cfg.sub_sample:
        for i in (1, 2):
            yield (f"subsample_conv{i}", "kernel"), f"subsample_conv{i}.weight", "conv1d"
    if cfg.learnable_blank_head:
        yield ("lm_head_frozen_kernel",), "lm_head_frozen_kernel", "same"
        yield ("blank_kernel",), "blank_kernel", "same"
    else:
        yield from _dense(("lm_head",), "lm_head", bias=False)


def whisper_seq2seq_param_table(cfg) -> Iterator[Entry]:
    """Every parameter of ``WhisperForConditionalGeneration``
    (``models/whisper_seq2seq.py``), HF's keys."""
    yield from _whisper_encoder(("encoder",), "model.encoder.", cfg.encoder_layers)
    d = ("decoder",)
    yield d + ("embed_tokens", "embedding"), "model.decoder.embed_tokens.weight", "same"
    yield d + ("embed_positions",), "model.decoder.embed_positions.weight", "same"
    for i in range(cfg.decoder_layers):
        yield from _whisper_layer(d + (f"layers_{i}",), f"model.decoder.layers.{i}", cross=True)
    yield from _ln(d + ("layer_norm",), "model.decoder.layer_norm")


def llm_asr_param_table(cfg, tree: Mapping[str, Any]) -> Iterator[Entry]:
    """Every parameter of ``LLMASRModel`` (``models/llm_asr.py``); ``tree``
    (Flax params, or ``llm_asr_tree_shape``) decides the decoder's optional
    entries."""
    yield from _prefixed(whisper_ctc_param_table(cfg.encoder), ("encoder",), "encoder.")
    if not cfg.prompt_with_tokens:
        yield from _dense(("linear",), "linear")
    yield ("soft_prompt",), "soft_prompt", "same"
    yield from _prefixed(decoder_param_table(cfg.decoder, tree["decoder"]), ("decoder",), "decoder.")


def llm_asr_tree_shape(cfg) -> Dict[str, Any]:
    return {"decoder": decoder_tree_shape(dataclasses.replace(cfg.decoder, add_cross_attention=False))}


def _positions(key: str, cfg) -> Dict[str, torch.Tensor]:
    return {key: torch.as_tensor(_sinusoids(cfg.max_source_positions, cfg.d_model), dtype=torch.float32)}


def whisper_ctc_state_dict_from_flax(tree: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Flax ``WhisperEncoderForCTC`` params -> float32 state dict of the port's."""
    return {**_to_state_dict(tree, whisper_ctc_param_table(cfg)), **_positions("encoder.embed_positions.weight", cfg)}


def whisper_ctc_flax_tree_from_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The inverse of ``whisper_ctc_state_dict_from_flax`` (gradients keyed by
    parameter name go back the same way)."""
    return _to_tree(sd, whisper_ctc_param_table(cfg))


def whisper_seq2seq_state_dict_from_flax(tree: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Flax ``WhisperForConditionalGeneration`` params -> float32 state dict of the port's."""
    return {**_to_state_dict(tree, whisper_seq2seq_param_table(cfg)),
            **_positions("model.encoder.embed_positions.weight", cfg)}


def whisper_seq2seq_flax_tree_from_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The inverse of ``whisper_seq2seq_state_dict_from_flax``."""
    return _to_tree(sd, whisper_seq2seq_param_table(cfg))


def llm_asr_state_dict_from_flax(tree: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Flax ``LLMASRModel`` params -> float32 state dict of the port's."""
    return {**_to_state_dict(tree, llm_asr_param_table(cfg, tree)),
            **_positions("encoder.encoder.embed_positions.weight", cfg.encoder)}


def llm_asr_flax_tree_from_state_dict(sd: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The inverse of ``llm_asr_state_dict_from_flax``."""
    return _to_tree(sd, llm_asr_param_table(cfg, llm_asr_tree_shape(cfg)))
