"""Turn a JAX model directory into a PyTorch port model directory.

    JAX_PLATFORMS=cpu python export_jax_checkpoint.py SRC_DIR DST_DIR

SRC_DIR is what the JAX package's CLIs write as ``final/``: an orbax
``params/`` tree and ``config.json``. DST_DIR receives ``config.json`` (the same
file) and ``pytorch_model.bin``, a flat state dict with the reference HF key
names, which ``huggingface_asr_tpu_torch``'s ``load_ctc_model``,
``load_aed_model`` and ``ASRPipeline`` load with ``strict=True``. A joint
CTC/attention model (its ``config.json`` nests ``encoder`` and ``decoder``)
goes through ``interop/export_hf.py::export_joint``; the other trees through
the port's tables (``huggingface_asr_tpu_torch/interop/from_jax.py``): a CTC
model, the BEST-RQ fine-tuning adapters included; and the trees of
``cli/pretrain.py``, BEST-RQ's (with the frozen quantizer's buffers, which the
JAX ``final/`` does not hold: the port builds them from the config) and
wav2vec2's, which ``train_ctc --from_pretrained`` fine-tunes from; and the
recipe families (``config.json`` tells them apart): the Whisper-encoder CTC
model (``d_model`` and ``llm_dim``), the Whisper seq2seq model (``d_model``
and ``decoder_layers``) and LLM-ASR (``number_of_prompt_tokens``). DST_DIR
may be SRC_DIR.

This script imports JAX, so it lives outside both packages; the port itself
never does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def export(src: str, dst: str) -> str:
    """Write ``dst/config.json`` and ``dst/pytorch_model.bin``; returns the
    kind ("ctc", "joint", "bestrq", "wav2vec2", "whisper_ctc", "whisper" or
    "llm_asr")."""
    import jax
    import numpy as np
    import torch

    from huggingface_asr_tpu.interop.export_hf import export_joint, save_torch_checkpoint
    from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig
    from huggingface_asr_tpu.training.model_factory import load_config, load_params
    from huggingface_asr_tpu_torch.interop import from_jax
    from huggingface_asr_tpu_torch.models.bestrq import make_bestrq_buffers
    from huggingface_asr_tpu_torch.training.model_factory import load_config as load_port_config

    with open(os.path.join(src, "config.json")) as f:
        keys = set(json.load(f))
    joint = {"encoder", "decoder"} <= keys and "number_of_prompt_tokens" not in keys
    params = jax.tree.map(np.asarray, load_params(src))
    os.makedirs(dst, exist_ok=True)
    if os.path.abspath(src) != os.path.abspath(dst):
        shutil.copy(os.path.join(src, "config.json"), os.path.join(dst, "config.json"))
    out = os.path.join(dst, "pytorch_model.bin")
    recipe = _recipe_kind(keys)
    if recipe is not None:
        from huggingface_asr_tpu_torch.models.llm_asr import LLMASRConfig
        from huggingface_asr_tpu_torch.models.whisper_ctc import WhisperCTCConfig
        from huggingface_asr_tpu_torch.models.whisper_seq2seq import WhisperSeq2SeqConfig

        cls, convert = {
            "whisper_ctc": (WhisperCTCConfig, from_jax.whisper_ctc_state_dict_from_flax),
            "whisper": (WhisperSeq2SeqConfig, from_jax.whisper_seq2seq_state_dict_from_flax),
            "llm_asr": (LLMASRConfig, from_jax.llm_asr_state_dict_from_flax),
        }[recipe]
        torch.save(convert(params, load_port_config(dst, cls)), out)
        return recipe
    if joint:
        cfg = load_config(src, JointCTCAttentionConfig)
        save_torch_checkpoint(export_joint(params, cfg.encoder, cfg.decoder), out)
        return "joint"
    cfg = load_port_config(dst)
    if "quantizer" in params:
        kind, state = "wav2vec2", from_jax.wav2vec2_state_dict_from_flax(params, cfg)
    elif "lm_head" not in params:
        kind, state = "bestrq", {**from_jax.pretraining_state_dict_from_flax({"params": params}, cfg),
                                 **{f"rpq.{k}": v for k, v in make_bestrq_buffers(cfg).items()}}
    else:
        kind, state = "ctc", from_jax.state_dict_from_flax(params, cfg)
    torch.save(state, out)
    return kind


def _recipe_kind(keys) -> "str | None":
    """The recipe family a ``config.json``'s fields name, or None."""
    if "number_of_prompt_tokens" in keys:
        return "llm_asr"
    if "d_model" in keys:
        return "whisper" if "decoder_layers" in keys else "whisper_ctc"
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="a JAX model directory (orbax params/ + config.json)")
    ap.add_argument("dst", help="the port model directory to write")
    args = ap.parse_args(argv)
    kind = export(args.src, args.dst)
    print(f"wrote {kind} model {os.path.join(args.dst, 'pytorch_model.bin')}")


if __name__ == "__main__":
    main()
