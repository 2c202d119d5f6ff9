"""Profile the PyTorch/CUDA port's training step on one NVIDIA GPU.

    python3 profile_train.py [--config FILE]

Builds the flagship trainer of ``chip_smoke.py`` at that script's shape
(``training_setup``: B=32 seeded synthetic utterances of 9.3-10 s, bf16 over
fp32 parameters, attention kernels selected, SpecAugment on), or with
``--config`` the trainer of a shipped config under configs/ (its own
attention_impl, "auto" in the files: the kernels on the card), warms up two
steps, then:

1. times 3 steps with CUDA events (median), and reads the peak allocated
   memory;
2. traces 3 more steps with ``torch.profiler`` and sums the device
   time by kernel group (the hand-written attention kernels by name, cuBLAS
   and cuDNN products, the CTC loss, elementwise and reduction kernels), and
   reports two busy shares: the union of the kernels' intervals over the traced
   window (the profiler slows the host, so this understates a host-bound
   step), and the traced device time per step over the untraced step time;
3. traces 3 evaluation steps on one batch and reports the step's time and the
   device time of the shift-form inference attention kernel (K5) in it.

Prints one JSON object with the card's name and power limit beside the
numbers. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BATCH, STEPS = 32, 3

GROUPS = (
    ("attention fwd kernel (K4)", ("train_fwd_bf16_kernel", "train_fwd_kernel")),
    ("attention bwd kernels (K4)", ("train_bwd_dq", "train_bwd_dkv")),  # the bf16 kernels on wgmma and the fp32 ones
    ("attention inference kernel (K5)", ("shift_bf16_kernel", "shift_attention_kernel")),
    ("matrix products (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "gemv", "splitKreduce", "cublas")),
    ("convolutions (cuDNN and native depthwise)", ("conv", "cudnn", "wgrad", "dgrad", "implicit")),
    ("CTC loss", ("ctc_loss",)),
    ("layer norm", ("layer_norm", "LayerNorm")),
    ("softmax", ("softmax",)),
    ("random numbers", ("distribution", "philox", "uniform")),
)


def group_of(name: str) -> str:
    for group, needles in GROUPS:
        if any(n in name for n in needles):
            return group
    return "elementwise, reductions, copies"


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None, help="a config file under configs/ instead of the flagship")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import config_file, training_setup

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    n = 2 + 2 * STEPS
    cfg = config_file(args.config) if args.config else None
    trainer, batches = training_setup(seed=0, batch_size=BATCH, n_batches=n, cfg=cfg)
    state = trainer.init_state()
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for b in batches[2:2 + STEPS]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = trainer.train_step(state, b)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches[2 + STEPS:]:
            state, m = trainer.train_step(state, b)
        torch.cuda.synchronize()
    spans, by_group, by_kernel = [], {}, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.time_range.end > ev.time_range.start:
            dur = (ev.time_range.end - ev.time_range.start) / 1e3  # ms
            spans.append((ev.time_range.start, ev.time_range.end))
            by_group[group_of(ev.name)] = by_group.get(group_of(ev.name), 0.0) + dur
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + dur
    # evaluation: the plain model with the shift-form inference attention kernel
    if cfg is not None:  # the trained weights in a model whose attention_impl is "pallas"
        evaluator, _ = training_setup(seed=0, batch_size=BATCH, n_batches=0,
                                      cfg=dataclasses.replace(cfg, attention_impl="pallas"))
        evaluator.model.load_state_dict(state.model.state_dict())
        trainer, state = evaluator, evaluator.init_state()
    trainer.eval_step(state, batches[0])
    torch.cuda.synchronize()
    eval_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as eval_prof:
        for _ in range(STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.eval_step(state, batches[0])
            end.record()
            torch.cuda.synchronize()
            eval_ms.append(start.elapsed_time(end))
    k5_ms = sum((ev.time_range.end - ev.time_range.start) / 1e3 for ev in eval_prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and group_of(ev.name) == "attention inference kernel (K5)") / STEPS
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    per_step = {k: v / STEPS for k, v in sorted(by_group.items(), key=lambda kv: -kv[1])}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:30]
    result = {
        "card": smi, "config": args.config or "flagship", "batch": BATCH, "seconds_of_audio": 10.0, "steps_timed": STEPS,
        "step_ms_median": float(np.median(times)), "step_ms_all": times,
        "peak_memory_gib": peak, "loss_last": float(m["loss"]),
        "device_ms_per_step_by_group": per_step,
        "device_ms_per_step_total": sum(per_step.values()),
        "device_busy_share_traced_window": busy / window if window else None,
        "device_share_of_untraced_step": sum(per_step.values()) / float(np.median(times)),
        "kernel_launches_per_step": len(spans) / STEPS,
        "top_kernels_ms_per_step": {k[:80]: v / STEPS for k, v in top},
        "eval_step_ms_median_traced": float(np.median(eval_ms)),
        "eval_step_k5_device_ms": k5_ms,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
