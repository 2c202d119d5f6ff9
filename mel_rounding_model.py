"""A model of K3 "high"'s DFT sums on the tensor core, on the CPU.

    python3 mel_rounding_model.py [N ...]     # mel-bin counts, 1 2 10 by default

``csrc/mel_bf16.cu`` forms each DFT coefficient in "high" from three bf16
products a k16 step (hi x hi, hi x lo, lo x hi) with wgmma's fp32
accumulation. The model takes each wgmma as the exact sum of its 16 products
and the accumulator, rounded toward zero to fp32, and compares, against the
folded product in fp64, on ``tests/test_torch_cuda.py``'s B=1 speech (and x
1e-4):

- one accumulator a pass (the kernel's earlier order),
- a fresh accumulator a box of 64 k, the boxes added with round-to-nearest,
- the same with the box's small terms before its large ones (the kernel's),

each beside the plain version of "high" on this CPU: the largest log-mel
error, its ratio to the plain version's, and the mean signed error; and the
largest error of ``csrc/mel.cu``'s "highest" contract (in-order fp32 sums,
``profile_kernel_variants.py::inorder_log_mel``). It predicts the card's
errors; it does not measure them (``profile_kernel_variants.py melerr`` does).
"""

import sys

import numpy as np
import torch

from huggingface_asr_tpu_torch.data.synthetic_speech import utterance
from huggingface_asr_tpu_torch.kernels import mel as K3
from huggingface_asr_tpu_torch.ops.features import LogMelConfig
from profile_kernel_variants import inorder_log_mel

B, S, BK = 1, 32003, 64  # tests/test_torch_cuda.py's first batch; k-values a box


def round_to_zero(v: np.ndarray) -> np.ndarray:
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy().astype(np.float64)


def coefficients(xh, xl, hi, lo, fresh: bool, small_first: bool) -> np.ndarray:
    """The DFT's (frames, 2 * bins) coefficients, wgmma by wgmma."""
    L = hi.shape[0]
    total = np.zeros((xh.shape[0], hi.shape[1]), np.float32)
    acc = np.zeros_like(total)
    for box in range(-(-L // BK)):
        if fresh and box:
            total, acc = (total.astype(np.float64) + acc).astype(np.float32), np.zeros_like(acc)
        steps = range(BK // 16 * box, min(BK // 16 * (box + 1), L // 16))
        if small_first:
            order = [(s, xh, lo) for s in steps] + [(s, xl, hi) for s in steps] + [(s, xh, hi) for s in steps]
        else:
            order = [(s, a, b) for s in steps for a, b in ((xh, hi), (xh, lo), (xl, hi))]
        for s, a, b in order:
            k = slice(16 * s, 16 * s + 16)
            acc = round_to_zero(acc.astype(np.float64) + a[:, k] @ b[k])
    return (total.astype(np.float64) + acc).astype(np.float32) if fresh else acc


def main(counts) -> None:
    rng = np.random.default_rng(B)  # tests/test_torch_cuda.py::_speech_batch
    wav = np.zeros((B, S), np.float32)
    w = utterance(S / 16000, rng)[0]
    wav[0, :len(w)] = w
    for quiet in (False, True):
        x = wav * np.float32(1e-4 if quiet else 1.0)
        for n_mel in counts:
            cfg = LogMelConfig(num_mel_bins=n_mel, matmul_precision="high")
            fe = K3.MelFrontEnd(cfg, device="cpu")
            n, L, hop = int(cfg.num_frames(S)), cfg.frame_length, cfg.hop_length
            hi, lo = (fe.dft[i].float().numpy().T.astype(np.float64) for i in (0, 1))
            frames = torch.from_numpy(x).unfold(1, L, hop)[0, :n].numpy()
            xh = bf16(frames)
            xl = bf16(frames - xh)
            nb, m = hi.shape[1] // 2, fe.mel.numpy().astype(np.float64)
            c64 = frames.astype(np.float64) @ K3.folded_bases(LogMelConfig(num_mel_bins=n_mel))[0]
            exact = np.log(np.maximum((c64[:, :nb] ** 2 + c64[:, nb:] ** 2) @ m, cfg.mel_floor))
            plain = K3.log_mel_plain(torch.from_numpy(x), n, fe.dft, fe.mel, hop, cfg.mel_floor, "high")
            e_plain = plain[0].double().numpy() - exact
            line = [f"quiet={quiet} bins={n_mel}:"]
            for name, fresh, small in (("one chain a pass", False, False), ("fresh a box", True, False),
                                       ("fresh a box, small terms first", True, True)):
                c = coefficients(xh, xl, hi, lo, fresh, small)
                power = (c[:, 0::2] * c[:, 0::2]).astype(np.float32) + (c[:, 1::2] * c[:, 1::2]).astype(np.float32)
                lm = np.log(np.maximum((power.astype(np.float64) @ m).astype(np.float32), cfg.mel_floor))
                err = lm.astype(np.float32).astype(np.float64) - exact
                line.append(f"{name} max {np.abs(err).max():.3e} "
                            f"({np.abs(err).max() / np.abs(e_plain).max():.2f}x) mean {err.mean():+.2e}")
            line.append(f"plain (CPU) max {np.abs(e_plain).max():.3e} mean {e_plain.mean():+.2e}")
            fe32 = K3.MelFrontEnd(LogMelConfig(num_mel_bins=n_mel), device="cpu")
            highest = inorder_log_mel(torch.from_numpy(x), n, fe32.dft, fe32.mel, hop, cfg.mel_floor)
            line.append(f"highest in order max {np.abs(highest[0].double().numpy() - exact).max():.3e}")
            print(" | ".join(line), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [1, 2, 10])
