"""Turn a JAX model directory into a PyTorch port model directory.

    JAX_PLATFORMS=cpu python export_jax_checkpoint.py SRC_DIR DST_DIR

SRC_DIR is what the JAX package's CLIs write as ``final/``: an orbax
``params/`` tree and ``config.json``. DST_DIR receives ``config.json`` (the same
file) and ``pytorch_model.bin``, a flat state dict with the reference HF key
names, which ``huggingface_asr_tpu_torch``'s ``load_ctc_model``,
``load_aed_model`` and ``ASRPipeline`` load with ``strict=True``. A CTC model
goes through ``interop/export_hf.py::export_ebranchformer_ctc``; a joint
CTC/attention model (its ``config.json`` nests ``encoder`` and ``decoder``)
through ``export_joint``. DST_DIR may be SRC_DIR.

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
    """Write ``dst/config.json`` and ``dst/pytorch_model.bin``; returns the kind ("ctc" or "joint")."""
    from huggingface_asr_tpu.interop.export_hf import (
        export_ebranchformer_ctc,
        export_joint,
        save_torch_checkpoint,
    )
    from huggingface_asr_tpu.models.configs import EBranchformerConfig
    from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig
    from huggingface_asr_tpu.training.model_factory import load_config, load_params

    with open(os.path.join(src, "config.json")) as f:
        joint = {"encoder", "decoder"} <= set(json.load(f))
    params = load_params(src)
    if joint:
        cfg = load_config(src, JointCTCAttentionConfig)
        state = export_joint(params, cfg.encoder, cfg.decoder)
    else:
        state = export_ebranchformer_ctc(params, load_config(src, EBranchformerConfig))
    os.makedirs(dst, exist_ok=True)
    if os.path.abspath(src) != os.path.abspath(dst):
        shutil.copy(os.path.join(src, "config.json"), os.path.join(dst, "config.json"))
    save_torch_checkpoint(state, os.path.join(dst, "pytorch_model.bin"))
    return "joint" if joint else "ctc"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="a JAX model directory (orbax params/ + config.json)")
    ap.add_argument("dst", help="the port model directory to write")
    args = ap.parse_args(argv)
    kind = export(args.src, args.dst)
    print(f"wrote {kind} model {os.path.join(args.dst, 'pytorch_model.bin')}")


if __name__ == "__main__":
    main()
