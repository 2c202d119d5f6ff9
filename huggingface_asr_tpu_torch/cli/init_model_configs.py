"""Model-configuration factory (counterpart of
``huggingface_asr_tpu/cli/init_model_configs.py``; reference:
src/examples/init_model_configuration.py — which pushes configs to the hub;
here they are written as JSON files for the training CLIs).

Generates the standard model-class configs used by the recipes: E-Branchformer
CTC base/small, BEST-RQ SSL 30M/90M-class encoders, and DeCRED base/small
joint configs (encoder+decoder).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os

from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser

logger = logging.getLogger(__name__)


def _enc(hidden, layers, heads, inter, conv_dim):
    return {
        "hidden_size": hidden,
        "num_hidden_layers": layers,
        "num_attention_heads": heads,
        "intermediate_size": inter,
        "conv_dim": [conv_dim, conv_dim],
        "conv_kernel": [3, 3],
        "conv_stride": [2, 2],
        "conv_padding": [1, 1],
        "num_fbanks": 80,
        "position_embeddings_type": "relative",
        "csgu_kernel_size": 31,
        "merge_conv_kernel": 31,
        "use_macaron_ff": True,
    }


def _dec(embd, layers, heads, head_locations, head_weights):
    return {
        "n_embd": embd,
        "n_layer": layers,
        "n_head": heads,
        "n_positions": 512,
        "head_locations": head_locations,
        "head_weights": head_weights,
        "average_logits": False,
        "add_cross_attention": True,
    }


CONFIGS = {
    # CTC model classes (reference scale anchors: base ≈ hidden 256 / 12 layers)
    "ebranchformer_small_ctc": _enc(176, 8, 4, 704, 176),
    "ebranchformer_base_ctc": _enc(256, 12, 8, 1024, 256),
    # SSL encoder classes (reference recipes/librispeech/ssl/{30M,90M}_ebranchformer)
    "ebranchformer_30m_ssl": {
        **_enc(256, 12, 8, 1024, 256),
        "best_rq_codebook_size": 8192, "best_rq_codebook_dim": 16,
        "best_rq_num_books": 1, "best_rq_in_dim": 320,
        "mask_time_prob": 0.65, "mask_time_length": 10,
    },
    "ebranchformer_90m_ssl": {
        **_enc(512, 17, 8, 2048, 512),
        "best_rq_codebook_size": 8192, "best_rq_codebook_dim": 16,
        "best_rq_num_books": 1, "best_rq_in_dim": 320,
        "mask_time_prob": 0.65, "mask_time_length": 10,
    },
    # DeCRED joint classes (aux head mid-decoder, weights 0.3/0.7; decode
    # defaults ctc_weight 0.3 / beams 5 per hf_shared_models/DeCRED_base.py)
    "decred_small": {
        "encoder": _enc(176, 12, 4, 704, 176),
        "decoder": _dec(176, 4, 4, [2], [0.3, 0.7]),
    },
    "decred_base": {
        "encoder": _enc(256, 16, 8, 1024, 256),
        "decoder": _dec(256, 6, 4, [3], [0.3, 0.7]),
    },
    # "ED" = same joint architecture without auxiliary decoder heads
    "ed_small": {
        "encoder": _enc(176, 12, 4, 704, 176),
        "decoder": _dec(176, 4, 4, [], [1.0]),
    },
    "ed_base": {
        "encoder": _enc(256, 16, 8, 1024, 256),
        "decoder": _dec(256, 6, 4, [], [1.0]),
    },
}


@dataclasses.dataclass(frozen=True)
class InitConfigArguments:
    configs_output_dir: str = "configs"
    only: str = ""  # comma-separated subset


def main(argv=None):
    parser = DataclassArgumentParser([InitConfigArguments])
    (args,) = parser.parse_args_into_dataclasses(argv)
    os.makedirs(args.configs_output_dir, exist_ok=True)
    names = args.only.split(",") if args.only else list(CONFIGS)
    for name in names:
        path = os.path.join(args.configs_output_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(CONFIGS[name], f, indent=2)
        logger.info("wrote %s", path)
    return {n: CONFIGS[n] for n in names}


if __name__ == "__main__":
    main()
