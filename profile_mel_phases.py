"""Where the time of the bf16 log-mel kernel goes, inside one block, on one NVIDIA GPU.

    python3 profile_mel_phases.py [CSRC]

Copies ``huggingface_asr_tpu_torch/csrc`` (or CSRC) to ``build/mel_phases/csrc``
with ``ASR_MEL_PHASES`` defined at the top of ``mel_bf16.cu``, so that thread 0
of each block of the first frame tile records ``clock64()`` at the end of the
staging, of each pass's products and of the block, and writes the cycles since
the block's start over its utterance's first log-mel row (see the kernel's
``MEL_PHASE``). Then runs ``"bf16"`` and ``"high"`` at B = 8 and 128 x 10 s of
seeded noise (three calls, the last read) and prints, for utterances 0, B/2
and B-1: the staging's end, each pass's end and the block's end, in cycles, and
the card's SM clock to turn them into time. The output of that copy is not a
log-mel and nothing else reads it. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch

    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.kernels import mel as K3
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    src = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "huggingface_asr_tpu_torch" / "csrc"
    dst = ROOT / "build" / "mel_phases" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    kernel = dst / "mel_bf16.cu"
    kernel.write_text("#define ASR_MEL_PHASES\n" + kernel.read_text())
    _build.CSRC = dst
    _build.library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = LogMelConfig()
    S = 160000
    n = int(cfg.num_frames(S))
    wav = torch.randn(128, S, generator=torch.Generator().manual_seed(0)).mul_(0.1).to(dev)
    for mode in ("bf16", "high"):
        fe = K3.MelFrontEnd(LogMelConfig(matmul_precision=mode), device=dev)
        for B in (8, 128):
            x = wav[:B].contiguous()
            for _ in range(3):
                out = K3.log_mel(x, n, fe.dft, fe.mel, cfg.hop_length, cfg.mel_floor, mode)
            torch.cuda.synchronize()
            for b in (0, B // 2, B - 1):
                row = out[b, 0, :16].cpu().tolist()
                ends = [int(v) for v in row[:int(row[15])]]
                print(f"{mode} B={B} utterance {b}: staged {ends[0]}, passes end {ends[1:-1]}, block ends "
                      f"{ends[-1]} (cycles)", flush=True)


if __name__ == "__main__":
    main()
