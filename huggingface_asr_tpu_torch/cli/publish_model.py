"""Publish a trained model directory as an HF-hub model repo (counterpart of
``huggingface_asr_tpu/cli/publish_model.py``).

Covers the reference's push_to_hub_final_model flow (reference:
src/trainers/train_enc_dec_asr.py:154-162) as a standalone step: build the
complete repo directory offline (torch weights in the reference's format,
config, tokenizer, feature-extractor config, model card with the optional
tracking-run URL section), then optionally push it.

  python -m huggingface_asr_tpu_torch.cli.publish_model \\
      --checkpoint out/final --tokenizer_name out/tok \\
      --output_dir out/hub_repo --model_type ctc \\
      [--repo_id user/model --push] [--run_url https://wandb.ai/...]
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True,
                    help="model dir (config.json + pytorch_model.bin, e.g. a final/)")
    ap.add_argument("--output_dir", required=True,
                    help="where to assemble the repo")
    ap.add_argument("--model_type", default="ctc", choices=["ctc", "joint"])
    ap.add_argument("--tokenizer_name", default=None)
    ap.add_argument("--repo_id", default=None,
                    help="hub repo id (defaults to output dir basename)")
    ap.add_argument("--language", default="en")
    ap.add_argument("--run_url", default=None,
                    help="tracking-run URL appended to the model card")
    ap.add_argument("--metrics_json", default=None,
                    help="path to a metrics JSON embedded in the card")
    ap.add_argument("--push", action="store_true",
                    help="upload to the hub after building (needs network)")
    ap.add_argument("--hub_token", default=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from huggingface_asr_tpu_torch.interop.publish import build_hub_repo, push_to_hub

    metrics = None
    if args.metrics_json:
        with open(args.metrics_json) as f:
            metrics = json.load(f)

    out = build_hub_repo(
        args.checkpoint, args.output_dir,
        model_type=args.model_type, tokenizer_dir=args.tokenizer_name,
        repo_name=args.repo_id, language=args.language,
        run_url=args.run_url, extra_metrics=metrics,
    )
    print(f"built hub repo at {out}")
    if args.push:
        repo_id = args.repo_id or out.rstrip("/").rsplit("/", 1)[-1]
        url = push_to_hub(out, repo_id, token=args.hub_token)
        print(f"pushed to {url}")
    return out


if __name__ == "__main__":
    main()
