"""Request latency and device-time breakdown of the port's CTC serving path on
one NVIDIA GPU.

    python3 profile_pipeline.py [--batches 1,8,32,128] [--seconds 10]
                                [--requests 20] [--profile 8,128] [--out FILE]
                                [--config FILE]

Loads the flagship E-Branchformer CTC with seeded random weights (the model
``chip_smoke.py`` serves), or with ``--config`` a shipped config under
configs/ (e.g. ebranchformer_small_ctc.json, the 176-wide model, which runs
the model's own conv front end before the K1 layers), through
``ASRPipeline(device="cuda")``. For each batch
size B it makes B seeded synthetic utterances of 93-100 % of ``--seconds``
(all in one length bucket), answers 3 warm-up requests, then times
``--requests`` requests on the host clock, profiler off; each request ends
when its transcripts are back on the host. The waveform goes to the card as
the pipeline sends it: a pageable host copy. It prints the median, quartiles
and p90 in ms and the RTFx (audio seconds / median request seconds).

For each B in ``--profile`` it then runs 5 requests under ``torch.profiler``
and prints the device time per request by kernel group (launch counts
beside), and the device busy share: the union of the device intervals over
the host wall time of those requests (the profiler's own overhead is in the
wall time, so the share is a lower bound). The full result goes to ``--out``
as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from chip_smoke import ROOT, config_file, flagship_model, seeded_model, speech

GROUPS = (  # (group, substring of the demangled kernel name), first match wins
    ("conv2", "conv2_kernel"),
    ("gemm with the LayerNorm prologue", "gemm_ln_"),
    ("gemm", "gemm_kernel"),
    ("rel_attention", "rel_attention_kernel"),
    ("dwconv_csgu", "dwconv_csgu_kernel"),
    ("dwconv_merge", "dwconv_merge_kernel"),
    ("pos_query", "pos_query_kernel"),
    ("layernorm", "layernorm_kernel"),
    ("conv1", "conv1_kernel"),
    ("mel", ("mel_kernel", "mel_bf16_kernel")),
    ("cmvn", "cmvn_kernel"),
    ("memcpy HtoD", "Memcpy HtoD"),
    ("memcpy DtoH", "Memcpy DtoH"),
    ("cuDNN / cuBLAS (a front end the subsampler kernel does not take, heads)",
     ("xmma", "nvjet", "cutlass", "cudnn", "convolve", "gemv", "gemmSN", "gemmk")),
)


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in ((keys,) if isinstance(keys, str) else keys)):
            return group
    return "torch ops (masking, final LN, heads, decode)"


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _audios(B: int, seconds: float, rng: np.random.Generator):
    return [speech(seconds * rng.uniform(0.93, 1.0), rng) for _ in range(B)]


def latency(pipe, audios, n: int) -> dict:
    for _ in range(3):
        pipe(audios)
    ms = []
    for _ in range(n):
        t = time.perf_counter()
        pipe(audios)
        ms.append((time.perf_counter() - t) * 1e3)
    audio_s = sum(len(a) for a in audios) / 16000
    q1, med, q3, p90 = np.percentile(ms, [25, 50, 75, 90])
    return {"B": len(audios), "requests": n, "audio_s": audio_s, "median_ms": med,
            "q1_ms": q1, "q3_ms": q3, "p90_ms": p90, "rtfx": audio_s / (med / 1e3)}


def breakdown(pipe, audios, n: int = 5) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe(audios)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            pipe(audios)
        wall_us = (time.perf_counter() - t) * 1e6
    groups: dict = {}
    intervals = []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        s, e = evt.time_range.start, evt.time_range.end
        intervals.append((s, e))
        g = groups.setdefault(_group(evt.name), {"ms": 0.0, "launches": 0})
        g["ms"] += (e - s) / 1e3 / n
        g["launches"] += 1
    for g in groups.values():
        g["launches"] /= n
    busy_us = _union_us(intervals)
    return {"B": len(audios), "requests": n, "wall_ms": wall_us / 1e3 / n,
            "device_busy_ms": busy_us / 1e3 / n,
            "device_busy_share": busy_us / wall_us if intervals else None,
            "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"]))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="1,8,32,128")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--profile", default="8,128")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile_pipeline.json"))
    ap.add_argument("--config", default=None, help="a config file under configs/ instead of the flagship")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from huggingface_asr_tpu_torch.training.model_factory import save_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    model_dir = os.path.join(ROOT, "build", "profile_model")
    save_params(seeded_model(config_file(args.config), args.seed) if args.config else flagship_model(args.seed),
                model_dir)

    class PieceTable:
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(i) for i in ids)

    pipe = ASRPipeline(model_dir, model_type="ctc", device="cuda", tokenizer=PieceTable())
    if not pipe._use_fused:
        sys.exit("the pipeline did not select the kernel path")
    rng = np.random.default_rng(args.seed)
    result = {"device": smi, "torch": torch.__version__, "seconds": args.seconds, "config": args.config or "flagship",
              "latency": [], "profile": []}
    for B in [int(b) for b in args.batches.split(",") if b]:
        r = latency(pipe, _audios(B, args.seconds, rng), args.requests)
        result["latency"].append(r)
        print(f"B={B:4d} x {args.seconds:g} s: median {r['median_ms']:.3f} ms "
              f"(q1 {r['q1_ms']:.3f}, q3 {r['q3_ms']:.3f}, p90 {r['p90_ms']:.3f}) "
              f"over {r['requests']} requests, RTFx {r['rtfx']:.1f}", flush=True)
    for B in [int(b) for b in args.profile.split(",") if b]:
        r = breakdown(pipe, _audios(B, args.seconds, rng))
        result["profile"].append(r)
        share = r["device_busy_share"]
        print(f"profile B={B} x {args.seconds:g} s: wall {r['wall_ms']:.3f} ms/request "
              f"(profiler on), device busy {r['device_busy_ms']:.3f} ms, share "
              f"{'not measured' if share is None else f'{share:.3f}'}", flush=True)
        for name, g in r["groups"].items():
            print(f"  {name:44s} {g['ms']:9.4f} ms  {g['launches']:6.1f} launches", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
