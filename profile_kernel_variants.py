"""A/B of kernel source variants on one NVIDIA GPU.

    python3 profile_kernel_variants.py [--out FILE] conv2,k4,k4bwd,k4wide,k5fp32,yardsticks,k1,k5,gemm,lngemm,dwconv,mel,melbf16[:N...],melerr[:N...],geluserving,posq,conv1,cmvn,ln,trace,ptxas DIR_A [DIR_B ...]

Each DIR is a directory holding a full copy of ``huggingface_asr_tpu_torch/csrc``
(the package's own directory is a valid DIR). Every variant is built and run in
a process of its own, in the order A B ... B A, so that two variants are
compared inside one call on one card. For each variant the script prints
ptxas's register and spill lines for the wgmma kernels, then holds conv2
(``conv2``, timed beside ``F.conv2d`` in bf16, device times), the bf16
training-attention forward (``k4``), the fused layer's
inference attention (``k1``) and the bf16 shift-form inference attention
(``k5``) against their plain versions at small, ragged and flagship shapes and
times them with CUDA events (median of 5 windows of 20 calls). For ``k1`` and
``k5`` it also prints the host's time per launch (the wrapper call at a tiny
shape, where the device never falls behind). ``k4bwd`` holds the four
gradients of the bf16 training attention against the plain backward and times
the backward alone; ``k4wide`` holds K4's forward and four gradients at 8 heads,
T=250, rate 0.1, against the plain version and gives their device times beside
their bounds and SDPA's in the same type (TF32 off), the backward's also by
kernel: bf16 at head 64, q_rot 512,
B=32 (the 512-wide config's step), fp32 at head 64, q_rot 256 (B=16) and 512
(B=16 and 32), and the flagship's fp32 step (head 32, q_rot 256, B=32); a tree
whose fp32 kernels stop at 256 says it refuses them, and a tree from before the
fp32 redesign runs its own backward entry (``legacy_fp32_backward``);
``k5fp32`` holds the shift-form inference attention against its plain version
at 8 heads, T=250, the smoke's ragged lengths (a zero-length row among them),
in fp32 and in bf16 at head 64, B=16 (the 512-wide config's evaluation batch)
and head 32, B=32 (the flagship's), and gives its device time beside its
bound and SDPA's in the same type (TF32 off) on the concatenated head the
smoke takes as its yardstick (``[q_u | q_rot]``, q_rot as wide as the config:
576 and 288 columns); then it runs the 512-wide config's model (seeded
weights, fp32, attention_impl "pallas") forward on a B=16 batch of seeded
log-mel features of 998 frames, the evaluation batch's shape, and prints its
host time (synchronized, median of 3), its device time and K5's 17
launches' share of it (profiler);
``yardsticks`` gives two library device times that the tables lacked beside
their kernels': SDPA at the flagship's rel_attention shape (B=8, T_pad=256,
both profiles of the kernel) and ``F.linear`` at the 176-wide config's FF1-in
(M = 2,048, K = 176, N = 704, the kernel with its GELU); ``gemm`` holds the GEMM with each epilogue the layer and
the subsampler use (activation, residual, dual output, a column slice of a
wider output, round-first at K=5120, a strided ``a``) against ``gemm_plain``
at M = 56, 2,048 and 32,768 rows, checks that rows past M and the other half
of a sliced output stay untouched, and times it beside ``F.linear``;
``dwconv`` holds both forms of the depthwise conv (CSGU with its LayerNorm
and gate, merge with its residual; C = 512 and 1,024, K = 31: the CSGU conv at
1,024 runs 128-channel slices behind its statistics pass) against their plain
versions at M = 2,048 and 32,768 rows and times them beside
``F.conv1d(groups=C)``, with the device times under the profiler; ``mel``
holds the log-mel kernel against its plain version at B = 8 and 128 x 10 s of
seeded synthetic speech, and against the folded product in fp64 on that speech
and on it x 1e-4 (its largest error at most twice the cuBLAS fp32 product's),
and times it beside the cuBLAS fp32 product (device times); ``melbf16`` holds the
log-mel kernel's "bf16" and "high" DFT modes (``csrc/mel_bf16.cu``) against
their plain version at B = 8 and 128 x 10 s of that speech at 80 mel bins, or
at each count N of ``melbf16:N[:N...]`` (``melbf16:23:80:128``), prints each
one's largest error against the folded product in fp64 beside the plain
version's and a digest of its output's bits (equal digests across trees:
equal outputs), and times it beside cuBLAS's bf16 product of the framed
operands and its bound (device times; a tree whose ``asr_log_mel_bf16``
predates the filter table, and whose bases put the cos columns before the
sin ones, or predates the table's segments and carry slots, is called with
its own arguments and layout, and skips a count whose table needs carry
slots); ``melerr[:N...]`` holds the log-mel kernel of each DFT mode and its
plain version against the folded product in fp64 at each count N (80 by
default) on ``tests/test_torch_cuda.py``'s speech batches (B=1, 3, 8, 24,
each also x 1e-4), printing each one's largest error and its mean signed error;
``geluserving`` times the FF1-in GEMM (K =
256, N = 1,024) with the serving GELU epilogue beside the exact one at M =
2,048 and 32,768, and conv2 with the serving GELU beside the exact one at B =
8 and 128 x 499 frames (device times, each held against its plain version
where that fits); ``posq`` holds the positional query at head widths 32 (8 heads, q_rot
256) and 64 (4 heads, q_rot 192) at M = 2,048 and 32,768 rows and times it
beside ``torch.bmm`` (device times); ``conv1`` and ``cmvn`` hold the subsampler's conv1 and the
utterance CMVN against their plain versions at B = 8 and 128 x 998 frames (seeded log-mel, the smoke's
ragged lengths) and time them beside their bounds, cmvn also beside a bf16 cast of its input (the same bytes
moved by one streaming kernel), conv1 also beside ``F.conv2d`` in bf16 (device times)
with the share of its outputs equal to the plain version's bit for bit, and beside ``fill_`` of its output (the
card's rate of writing those bytes); ``ln`` holds the LayerNorm at M = 2,048 and 32,768 rows (D = 256) against its
plain version and times it beside ``F.layer_norm`` in bf16 (device times); ``lngemm`` runs the five GEMMs that
read a LayerNorm of their input (FF1's and FF2's intermediate dense and cgMLP's channel_proj1 with the GELU, the
serving GELU too, the QKV with its second output, the subsampler's projection with ``round_first``) at the
flagship's widths and the 512-wide config's (the projection at 256 only), M = 2,048, 8,192 and 32,768 rows: a tree with
``asr_gemm_ln_bf16`` through ``ln_gemm`` (the LayerNorm in the GEMM's prologue), and also through its own
``layer_norm`` then ``gemm``, beside ``F.layer_norm`` + ``F.linear`` in bf16; a tree without it through that
chain alone; each output held against ``ln_gemm_plain``, with a digest of its bits (equal digests across trees: equal
outputs) and device times; ``trace`` takes 100 profiler
traces of 10 calls each of the CSGU conv at C = 512 and 1,024, a GEMM and the LayerNorm (B=8 x 256 rows), opened
and closed right at the calls and 20 ms before and after them, and counts the traces that hold fewer kernel records than host
launch records, and whether the first or the last call's record is the one missing. ``ptxas`` prints
every source's ptxas lines and runs nothing (variants whose C entry points differ from this tree's).
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from chip_smoke import device_ms, host_us_per_launch, timed  # noqa: E402

CONV2_SHAPES = [(3, 15, 8), (3, 79, 40), (8, 499, 256), (8, 999, 504), (128, 499, 256)]  # (B, T1, T2)
K4_SHAPES = [  # (B, T, H, D, lengths or None for the smoke's ragged lengths, rate)
    (3, 70, 4, 128, [70, 33, 0], 0.0), (3, 129, 4, 128, [129, 64, 1], 0.1),
    (4, 333, 8, 256, [333, 1, 0, 200], 0.1), (8, 500, 8, 256, None, 0.1), (32, 250, 8, 256, None, 0.1),
]
K4BWD_SHAPES = [(3, 70, 2, 64, [70, 1, 0], 0.1)] + K4_SHAPES
# (dtype, B, head width, q_rot width) of ``k4wide``, 8 heads, T=250: the 512-wide config's bf16 step, fp32 at
# head 64 and q_rot 256 and 512, and the flagship's fp32 step (head 32, q_rot 256, B=32)
K4WIDE_CASES = [("bfloat16", 32, 64, 512), ("float32", 16, 64, 256), ("float32", 16, 64, 512),
                ("float32", 32, 64, 512), ("float32", 32, 32, 256)]
# (dtype, B, head width) of ``k5fp32``, 8 heads, T=250
K5FP32_CASES = [("float32", 16, 64), ("float32", 32, 32), ("bfloat16", 16, 64), ("bfloat16", 32, 32)]
K1_SHAPES = [  # (B, T_pad, H, D, lengths or None for the smoke's ragged lengths)
    (2, 64, 4, 128, [64, 0]), (3, 192, 4, 128, [187, 1, 0]), (2, 752, 8, 256, [752, 0]), (3, 752, 8, 256, [700, 1, 440]),
    (8, 56, 8, 256, None), (8, 256, 8, 256, None), (8, 512, 8, 256, None), (128, 256, 8, 256, None),
]
K5_SHAPES = [  # (B, T, H, lengths or None)
    (3, 70, 4, [70, 33, 0]), (3, 129, 4, [129, 64, 1]), (4, 333, 8, [333, 1, 0, 200]), (8, 500, 8, None),
    (32, 250, 8, None),
]


GEMM_ROWS = (56, 2048, 32768)
DWCONV_SHAPES = [(8, 256), (128, 256)]  # (B, T_pad): M = 2,048 and 32,768 rows
GEMM_CASES = [  # (name, K, N, keyword arguments of the call besides bias)
    ("ff_in +gelu", 256, 1024, dict(act="gelu")),
    ("ff_in no act", 256, 1024, dict()),
    ("ff_out +residual", 1024, 256, dict(residual=True, alpha=0.5)),
    ("qkv dual", 256, 768, dict(bias2=True)),
    ("wo -> merged[:, :D]", 256, 256, dict(out_half=0)),
    ("cg_w2 -> merged[:, D:]", 512, 256, dict(out_half=1)),
    ("merge +residual, strided a", 512, 256, dict(residual=True, alpha=1.0, strided_a=True)),
    ("out-dense round_first", 5120, 256, dict(round_first=True)),
    ("narrow D=64", 64, 192, dict(bias2=True)),
    ("K=96", 96, 64, dict(act="swish")),
]


def gemm_case(K1, M, K, N, kw, dev, gen):
    """(kernel call, plain call, library call, untouched-memory check) of one GEMM case."""
    import torch
    import torch.nn.functional as F

    mk = lambda *s: torch.randn(*s, generator=gen).bfloat16().to(dev)  # noqa: E731
    kw = dict(kw)
    a = mk(M, 2 * K)[:, K:] if kw.pop("strided_a", False) else mk(M, K)
    w = mk(K, N) * (K ** -0.5)
    bias = mk(N).float()
    if kw.pop("residual", False):
        kw["residual"] = mk(M, N)
    if kw.pop("bias2", False):
        kw["bias2"] = mk(N // 3).float()
    half = kw.pop("out_half", None)
    guard = torch.full((M + 8, 2 * N), 7.0, dtype=torch.bfloat16, device=dev)  # rows past M, the other half
    out = None if half is None else guard[:M, half * N:(half + 1) * N]

    def kernel():
        return K1.gemm(a, w, bias, out=out, **kw)

    def plain():
        return K1.gemm_plain(a, w, bias, **kw)

    def untouched():
        if half is None:
            return True
        other = guard[:M, (1 - half) * N:(2 - half) * N]
        return bool((other == 7.0).all()) and bool((guard[M:] == 7.0).all())

    w_t, b16 = w.t(), bias.bfloat16()
    a_lin = a.contiguous()
    return kernel, plain, (lambda: F.linear(a_lin, w_t, b16)), untouched


def smoke_lengths(B: int, T: int):
    lens = [T - (i * T) // (2 * B) for i in range(B)]
    lens[B // 2] = 0
    return lens


def melbf16_variant(csrc: str, dev, bins=(80,)) -> None:
    """The ``melbf16`` mode on the variant whose sources are ``csrc``, at
    each count of mel bins in ``bins``."""
    import hashlib

    import torch

    from chip_smoke import bound, mel_bf16_work, speech
    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.kernels import mel as K3
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig

    source = (pathlib.Path(csrc) / "mel_bf16.cu").read_text()
    # a tree of the first design: no filter table, the cos columns before the sin ones; a tree of one
    # segment a filter: the table without its segment rows' count and carry slots
    table = "int table_rows" in source
    segments = "int n_slots" in source
    rng = np.random.default_rng(0)
    S = 160000
    wav_all = np.zeros((128, S), np.float32)
    for i in range(128):
        w_ = speech(10.0 - 0.05 * (i % 16), rng)
        wav_all[i, :len(w_)] = w_
    wav_all = torch.from_numpy(wav_all).to(dev)
    for n_mel in bins:
        cfg = LogMelConfig(num_mel_bins=n_mel)
        dft_np, mel_np = K3.folded_bases(cfg)
        if not segments and K3._kernel_table(mel_np)[2]:
            print(f"melbf16 bins={n_mel}: this tree's kernel takes no carry slots, which the table needs", flush=True)
            continue
        dft32, mel = torch.from_numpy(dft_np).to(dev), torch.from_numpy(mel_np).to(dev)
        hop, floor, L = cfg.hop_length, cfg.mel_floor, cfg.frame_length
        n = int(cfg.num_frames(S))
        for mode in ("bf16", "high"):
            bases = K3.split_bases(dft_np, mode).to(dev)
            first = torch.stack(K3._split_hi_lo(dft32.t().contiguous())[:1 if mode == "bf16" else 2]).contiguous()
            rows = torch.from_numpy(K3.mel_kernel_table(mel_np)).to(dev)

            def kernel(x):
                if segments:
                    return K3.log_mel(x, n, bases, mel, hop, floor, mode)
                out = torch.empty(x.shape[0], n, mel.shape[1], dtype=torch.float32, device=dev)
                if table:
                    _build.launch("asr_log_mel_bf16", "pppipiiiiiiifi", x.data_ptr(), bases.data_ptr(),
                                  rows.data_ptr(), rows.shape[0], out.data_ptr(), x.shape[0], S, n, L, hop,
                                  mel.shape[0], mel.shape[1], float(floor), int(mode == "high"),
                                  label=f"asr_log_mel_{mode}")
                else:
                    _build.launch("asr_log_mel_bf16", "ppppiiiiiiifi", x.data_ptr(), first.data_ptr(),
                                  mel.data_ptr(), out.data_ptr(), x.shape[0], S, n, L, hop, mel.shape[0],
                                  mel.shape[1], float(floor), int(mode == "high"), label=f"asr_log_mel_{mode}")
                return out

            for B in (8, 128):
                x = wav_all[:B]
                with torch.no_grad():
                    got, ref = kernel(x), K3.log_mel_plain(x, n, bases, mel, hop, floor, mode)
                    exact = K3.log_mel_plain(x.double(), n, dft32.double(), mel.double(), hop, floor)
                    err = float((got - ref).abs().max())
                    ok = bool(torch.isfinite(got).all()) and err <= 1e-3 * max(1.0, float(ref.abs().max()))
                    err_k = float((got.double() - exact).abs().max())
                    err_p = float((ref.double() - exact).abs().max())
                    digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
                    frames16 = x.unfold(1, L, hop)[:, :n].to(torch.bfloat16).contiguous()
                    hi_t = bases[0].t()
                    bound_ms, by = bound(*mel_bf16_work(x, n, bases, mel))
                    print(f"melbf16 {mode} bins={n_mel} B={B}: err={err:.3e} {'ok' if ok else 'FAIL'} "
                          f"fp64 kernel {err_k:.4e} plain {err_p:.4e} digest={digest} "
                          f"ms={timed(lambda: kernel(x)):.4f} device_ms={device_ms(lambda: kernel(x)):.4f} "
                          f"bound_ms={bound_ms:.4f} ({by}) "
                          f"cublas_bf16_device_ms={device_ms(lambda: frames16 @ hi_t):.4f}", flush=True)
                    del got, ref, exact, frames16
                torch.cuda.empty_cache()


def inorder_log_mel(wav, n_frames, dft, mel, hop, floor):
    """``csrc/mel.cu``'s contract ("highest"), emulated: each DFT sum over k in
    order and each mel sum over bins in order, an fp32 FMA a term (the
    product exact in fp64, the sum rounded to fp64 and then to fp32: two
    roundings, which part from one only on a tie), the power c*c + s*s
    rounded at each op, then the fp32 log. A witness of which order the
    kernel's error comes from."""
    import torch

    L, nb = dft.shape[0], dft.shape[1] // 2
    frames, d = wav.unfold(1, L, hop)[:, :n_frames].double(), dft.double()
    acc = torch.zeros(*frames.shape[:2], 2 * nb, dtype=torch.float32, device=wav.device)
    for k in range(L):
        acc = (frames[..., k:k + 1] * d[k] + acc.double()).float()
    power = acc[..., :nb] * acc[..., :nb] + acc[..., nb:] * acc[..., nb:]
    m, w = torch.zeros(*frames.shape[:2], mel.shape[1], dtype=torch.float32, device=wav.device), mel.double()
    for j in range(nb):
        m = (power[..., j:j + 1].double() * w[j] + m.double()).float()
    return torch.log(torch.clamp(m, min=floor))


def melerr_variant(dev, bins) -> None:
    """The ``melerr`` mode: the log-mel kernel of each DFT mode and its plain
    version against the folded product in fp64, at each count in ``bins``,
    on the card tests' speech batches (B=1 x 2 s, B=3 x 3 s, B=8 and 24 x 10 s,
    and each x 1e-4): the largest error and the mean signed one (a bias) of each;
    in "highest" also ``inorder_log_mel``'s largest error and the share of the
    kernel's outputs equal to it."""
    import torch

    from huggingface_asr_tpu_torch.data.synthetic_speech import utterance
    from huggingface_asr_tpu_torch.kernels import mel as K3
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig

    for B, S in ((1, 32003), (3, 48001), (8, 160002), (24, 160002)):
        rng = np.random.default_rng(B)  # tests/test_torch_cuda.py::_speech_batch
        wav_np = np.zeros((B, S), np.float32)
        for i in range(B):
            w_ = utterance((S - i * (S // (4 * B))) / 16000, rng)[0]
            wav_np[i, :len(w_)] = w_
        for quiet in (False, True):
            wav = torch.from_numpy(wav_np * (1e-4 if quiet else 1.0)).to(dev)
            for n_mel in bins:
                line = [f"melerr B={B} S={S} quiet={quiet} bins={n_mel}:"]
                for mode in K3.MEL_MODES:
                    cfg = LogMelConfig(num_mel_bins=n_mel, matmul_precision=mode)
                    fe = K3.MelFrontEnd(cfg, device=dev)
                    n = int(cfg.num_frames(S))
                    args = (n, fe.dft, fe.mel, cfg.hop_length, cfg.mel_floor, mode)
                    with torch.no_grad():
                        got, plain = K3.log_mel(wav, *args).double(), K3.log_mel_plain(wav, *args).double()
                        dft64 = torch.from_numpy(K3.folded_bases(cfg)[0]).to(dev).double()
                        exact = K3.log_mel_plain(wav.double(), n, dft64, fe.mel.double(), cfg.hop_length,
                                                 cfg.mel_floor)
                    ek, ep = got - exact, plain - exact
                    line.append(f"{mode} max kernel {float(ek.abs().max()):.3e} plain {float(ep.abs().max()):.3e} "
                                f"({float(ek.abs().max()) / float(ep.abs().max()):.2f}x) mean kernel "
                                f"{float(ek.mean()):+.2e} plain {float(ep.mean()):+.2e} scale "
                                f"{float(exact.abs().max()):.1f}")
                    if mode == "highest":
                        with torch.no_grad():
                            wit = inorder_log_mel(wav, *args[:5]).double()
                        line.append(f"highest in-order witness max {float((wit - exact).abs().max()):.3e}, "
                                    f"kernel equal to it on {float((got == wit).double().mean()):.4f}, "
                                    f"largest gap {float((got - wit).abs().max()):.3e}")
                print(" | ".join(line), flush=True)


def geluserving_variant(dev) -> None:
    """The ``geluserving`` mode: the GEMM's and conv2's serving GELU epilogues
    beside their exact ones."""
    import torch

    from chip_smoke import bound
    from huggingface_asr_tpu_torch.kernels import layer as K1
    from huggingface_asr_tpu_torch.kernels import subsample as K2

    g = torch.Generator().manual_seed(20)
    K, N = 256, 1024
    w = (torch.randn(K, N, generator=g) * K ** -0.5).bfloat16().to(dev)
    bias = (torch.randn(N, generator=g) * 0.1).to(dev)
    for M in (2048, 32768):
        a = torch.randn(M, K, generator=g).bfloat16().to(dev)
        bound_ms, by = bound(2.0 * M * K * N, 2 * (M * K + K * N + M * N) + 4 * N, "bf16")
        line = [f"geluserving gemm M={M} K={K} N={N}: bound_ms={bound_ms:.4f} ({by})"]
        for act in ("gelu_serving", "gelu"):
            call = lambda: K1.gemm(a, w, bias, act=act)  # noqa: E731
            got, ref = call(), K1.gemm_plain(a, w, bias, act=act)
            err = float((got.float() - ref.float()).abs().max())
            ok = err <= 2 ** -6 * max(1.0, float(ref.float().abs().max()))
            line.append(f"{act} err={err:.3e} {'ok' if ok else 'FAIL'} ms={timed(call):.4f} "
                        f"device_ms={device_ms(call):.4f}")
        print("; ".join(line), flush=True)
        del a, got, ref
    for B in (8, 128):
        T1, T2 = 499, 256
        y1 = torch.randn(B, T1, 40, 256, generator=g).bfloat16().to(dev)
        w2 = (torch.randn(9 * 256, 256, generator=g) * 0.02).bfloat16().to(dev)
        b2 = (torch.randn(256, generator=g) * 0.1).bfloat16().float().to(dev)
        line = [f"geluserving conv2 B={B} T2={T2}"]
        for profile in ("serving", "exact"):
            call = lambda: K2.conv2(y1, w2, b2, T2, profile)  # noqa: E731
            verdict = "unchecked"
            if B <= 8:  # the plain version at B=128 needs tens of GB
                got, ref = call().float(), K2.conv2_plain(y1, w2, b2, T2, profile).float()
                err = float((got - ref).abs().max())
                verdict = f"err={err:.3e} {'ok' if err <= 2 ** -6 * max(1.0, float(ref.abs().max())) else 'FAIL'}"
            with torch.no_grad():
                line.append(f"{profile} {verdict} ms={timed(call):.4f} device_ms={device_ms(call):.4f}")
        print("; ".join(line), flush=True)
        del y1
        torch.cuda.empty_cache()


def legacy_fp32_backward(TA) -> None:
    """Give ``TA._KernelFunction`` (``kernels/train_attention.py``) the fp32
    backward of a tree from before the fp32 kernels' redesign: one entry,
    ``asr_rel_attention_train_bwd``, with a delta scratch and no dS, so that
    ``k4wide`` can A/B such a tree's ``csrc/`` under this tree's wrapper."""
    import torch

    from huggingface_asr_tpu_torch.kernels import _build

    backward = TA._KernelFunction.backward

    def patched(ctx, d_out):
        q_u, q_rot, k, v, k_std, lengths, stats = ctx.saved_tensors[:7]
        if q_u.dtype != torch.float32:
            return backward(ctx, d_out)
        (B, T, H), (dh, D) = ctx.tail[:3], ctx.widths
        d_out = TA._pad_last(d_out.contiguous(), q_u.shape[-1])
        dq_u, dq_rot, dk, dv = (torch.empty_like(t) for t in (q_u, q_rot, k, v))
        delta = torch.empty(B, H, T, dtype=torch.float32, device=q_u.device)
        _build.launch("asr_rel_attention_train_bwd", "pppppppppppppiiiiiifuufii",
                      q_u.data_ptr(), q_rot.data_ptr(), k.data_ptr(), v.data_ptr(), k_std.data_ptr(),
                      lengths.data_ptr(), d_out.data_ptr(), stats.data_ptr(), delta.data_ptr(), dq_u.data_ptr(),
                      dq_rot.data_ptr(), dk.data_ptr(), dv.data_ptr(), *ctx.tail)
        return dq_u[..., :dh], dq_rot[..., :D], dk[..., :dh], dv[..., :dh], None, None, None, None, None

    TA._KernelFunction.backward = staticmethod(patched)


LNGEMM_SITES = [  # (name, N for (D, I), keyword arguments besides bias, widths it runs at)
    ("ff1_wi +gelu", lambda D, I: I, dict(act="gelu"), (256, 512)),
    ("ff1_wi +serving gelu", lambda D, I: I, dict(act="gelu_serving"), (256, 512)),
    ("qkv dual", lambda D, I: 3 * D, dict(bias2=True), (256, 512)),
    ("cg_w1 +gelu", lambda D, I: I, dict(act="gelu"), (256, 512)),
    ("ff2_wi +gelu", lambda D, I: I, dict(act="gelu"), (256, 512)),
    ("wproj round_first", lambda D, I: D, dict(round_first=True), (256,)),
]


def lngemm_variant(K1, dev) -> None:
    """``lngemm``: the LayerNorm-fed GEMMs through this tree's route (see the module docstring)."""
    import hashlib

    import torch
    import torch.nn.functional as F

    from huggingface_asr_tpu_torch.kernels import _build

    fused = hasattr(_build.library(), "asr_gemm_ln_bf16")
    for D, I in ((256, 1024), (512, 2048)):
        for name, n_of, kw0, widths in LNGEMM_SITES:
            if D not in widths:
                continue
            for M in (2048, 8192, 32768):
                N = n_of(D, I)
                gen = torch.Generator().manual_seed(M + D + N)
                x = (torch.randn(M, D, generator=gen) * 2.0 + 0.3).bfloat16().to(dev)
                g = (1.0 + 0.1 * torch.randn(D, generator=gen)).to(dev)
                b = (0.1 * torch.randn(D, generator=gen)).to(dev)
                w = (torch.randn(D, N, generator=gen) * D ** -0.5).bfloat16().to(dev)
                bias = (0.1 * torch.randn(N, generator=gen)).bfloat16().float().to(dev)
                kw = dict(kw0)
                if kw.pop("bias2", False):
                    kw["bias2"] = (0.1 * torch.randn(D, generator=gen)).bfloat16().float().to(dev)
                chain = lambda: K1.gemm(K1.layer_norm(x, g, b, 1e-5), w, bias, **kw)  # noqa: E731
                call = (lambda: K1.ln_gemm(x, g, b, 1e-5, w, bias, **kw)) if fused else chain  # noqa: E731
                got, ref = call(), K1.ln_gemm_plain(x, g, b, 1e-5, w, bias, **kw)
                torch.cuda.synchronize()
                pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
                err = max(float((o.float() - r.float()).abs().max()) for o, r in pairs)
                ok = all(float((o.float() - r.float()).abs().max()) <= 2 ** -6 * max(1.0, float(r.float().abs().max()))
                         for o, r in pairs)
                digest = hashlib.sha1(b"".join(o.view(torch.int16).cpu().numpy().tobytes() for o, _ in pairs))
                line = (f"lngemm {name} D={D} M={M} N={N} {'fused' if fused else 'chain'}: err={err:.3e} "
                        f"{'ok' if ok else 'FAIL'} digest={digest.hexdigest()[:16]} device_ms={device_ms(call):.4f}")
                if fused:
                    g16, b16, w_t = g.bfloat16(), b.bfloat16(), w.t().contiguous()
                    library = lambda: F.linear(F.layer_norm(x, (D,), g16, b16, 1e-5), w_t, bias.bfloat16())  # noqa: E731
                    line += (f" chain_device_ms={device_ms(chain):.4f} "
                             f"layer_norm+linear_device_ms={device_ms(library):.4f}")
                print(line, flush=True)


def run_variant(csrc: str, what: str) -> None:
    import torch

    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.kernels import layer as K1
    from huggingface_asr_tpu_torch.kernels import subsample as K2
    from huggingface_asr_tpu_torch.kernels.attention import rel_attention, rel_attention_plain_shift
    from huggingface_asr_tpu_torch.kernels.train_attention import rel_attention_train, rel_attention_train_plain

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    _build.CSRC = pathlib.Path(csrc).resolve()
    _build.library()
    sources = {"conv2": "conv2", "k4": "train_fwd", "k4bwd": "train_bwd", "k4wide": "rel_attention_train",
               "k5fp32": "shift",
               "yardsticks": "layer.cu",
               "k1": "rel_attention.cu", "k5": "shift",
               "gemm": "layer.cu", "dwconv": "dwconv", "mel": "mel.cu", "melbf16": "mel_bf16", "melerr": "mel", "posq": "layer.cu",
               "geluserving": "layer.cu", "lngemm": "gemm_ln.cu",
               "conv1": "subsample.cu", "cmvn": "mel.cu", "ln": "layer.cu", "trace": "dwconv", "ptxas": ""}
    keep = False
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if line.startswith("=="):
            keep = any(sources[mode.split(":")[0]] in line for mode in what.split(","))
        # (C7517 and C7519 only say where the compiler put the waits around a product)
        if keep and any(s in line for s in ("Used", "spill", "C751", "error", "Compiling entry")) \
                and "C7517" not in line and "C7519" not in line:
            print("  ", line.strip()[:200])
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    tol = 2 ** -6
    if "gemm" in what.split(","):
        for M in GEMM_ROWS:
            for name, K, N, kw in GEMM_CASES:
                gen = torch.Generator().manual_seed(M + K + N)
                kernel, plain, library, untouched = gemm_case(K1, M, K, N, kw, dev, gen)
                got, ref = kernel(), plain()
                torch.cuda.synchronize()
                pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
                err = max(float((a.float() - r.float()).abs().max()) for a, r in pairs)
                scale = max(float(r.float().abs().max()) for _, r in pairs)
                ok = err <= tol * max(1.0, scale) and untouched()
                print(f"gemm M={M} K={K} N={N} {name}: err={err:.3e} {'ok' if ok else 'FAIL'} "
                      f"ms={timed(kernel):.4f} device_ms={device_ms(kernel):.4f} linear_ms={timed(library):.4f} "
                      f"linear_device_ms={device_ms(library):.4f}", flush=True)
                if M == GEMM_ROWS[0] and name.startswith("ff_in"):
                    print(f"gemm host us per launch: {host_us_per_launch(kernel):.2f} "
                          f"(F.linear {host_us_per_launch(library):.2f})", flush=True)
    if "dwconv" in what.split(","):
        import torch.nn.functional as F

        K = 31
        for C, (B, T) in ((c, bt) for c in (512, 1024) for bt in DWCONV_SHAPES):
            gen = torch.Generator().manual_seed(B + T)
            l = torch.randn(B * T, 2 * C, generator=gen).bfloat16().to(dev)
            x = torch.randn(B * T, C, generator=gen).bfloat16().to(dev)
            w = (torch.randn(K, C, generator=gen) * K ** -0.5).bfloat16().to(dev)
            bias, ln_b = (torch.randn(C, generator=gen) * 0.1).to(dev), (torch.randn(C, generator=gen) * 0.1).to(dev)
            ln_g = (1.0 + 0.1 * torch.randn(C, generator=gen)).to(dev)
            w_lib = w.t().reshape(C, 1, K).contiguous()
            t_valid = T - 6
            calls = {
                "csgu": (lambda: K1.csgu(l, ln_g, ln_b, w, bias, B, T, t_valid, "identity", 1e-5),
                         lambda: K1.csgu_plain(l, ln_g, ln_b, w, bias, B, T, t_valid, "identity", 1e-5),
                         l[:, C:].reshape(B, T, C).transpose(1, 2)),
                "merge": (lambda: K1.merge_conv(x, w, bias, B, T, t_valid),
                          lambda: K1.merge_conv_plain(x, w, bias, B, T, t_valid),
                          x.reshape(B, T, C).transpose(1, 2)),
            }
            for name, (kernel, plain, lib_in) in calls.items():
                got, ref = kernel().float(), plain().float()
                err = float((got - ref).abs().max())
                ok = bool(torch.isfinite(got).all()) and err <= 2 ** -7 * max(1.0, float(ref.abs().max()))
                library = lambda: F.conv1d(lib_in, w_lib, padding=(K - 1) // 2, groups=C)  # noqa: E731
                with torch.no_grad():
                    print(f"dwconv {name} C={C} B={B} T={T} M={B * T}: err={err:.3e} {'ok' if ok else 'FAIL'} "
                          f"ms={timed(kernel):.4f} device_ms={device_ms(kernel):.4f} conv1d_ms={timed(library):.4f} "
                          f"conv1d_device_ms={device_ms(library):.4f}", flush=True)
            del l, x
            torch.cuda.empty_cache()
    if "trace" in what.split(","):
        # how often a profiler trace loses kernel records: 100 traces of 10
        # calls each, per call; "bare" opens and closes the trace right at
        # the calls, "padded" TRACE_PAD_S before and after them (as
        # chip_smoke.device_kernel_ms does)
        import time

        from torch.profiler import ProfilerActivity, profile

        from chip_smoke import TRACE_PAD_S

        B, T, K = 8, 256, 31
        gen = torch.Generator().manual_seed(5)
        calls = {}
        for C in (512, 1024):
            l = torch.randn(B * T, 2 * C, generator=gen).bfloat16().to(dev)
            w = (torch.randn(K, C, generator=gen) * K ** -0.5).bfloat16().to(dev)
            vec = lambda: (1.0 + 0.1 * torch.randn(C, generator=gen)).to(dev)  # noqa: E731
            calls[f"csgu C={C}"] = (lambda l=l, w=w, a=vec(), b=vec(), c=vec(), C=C:
                                    K1.csgu(l, a, b, w, c, B, T, T - 6, "identity", 1e-5))
        a, wt = torch.randn(B * T, 512, generator=gen).bfloat16().to(dev), \
            (torch.randn(512, 2048, generator=gen) * 512 ** -0.5).bfloat16().to(dev)
        ln_g, ln_b = torch.ones(512, device=dev), torch.zeros(512, device=dev)
        calls["gemm K=512 N=2048"] = lambda: K1.gemm(a, wt)
        calls["layernorm D=512"] = lambda: K1.layer_norm(a, ln_g, ln_b, 1e-5)
        for mode in ("bare", "padded"):
            for name, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                counts, per_call = [], []
                for _ in range(100):
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        if mode == "padded":
                            time.sleep(TRACE_PAD_S)
                        for _ in range(10):
                            fn()
                        torch.cuda.synchronize()
                        if mode == "padded":
                            time.sleep(TRACE_PAD_S)
                    events = prof.events()
                    kernels = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA]
                    launches = sorted((ev for ev in events if "Launch" in ev.name), key=lambda e: e.time_range.start)
                    # which call's record is missing: the records' starts against the launches'
                    first, last = (min(ev.time_range.start for ev in kernels), max(ev.time_range.start for ev in kernels)) \
                        if kernels else (None, None)
                    counts.append((len(kernels), len(launches),
                                   first is not None and len(launches) > 1 and first >= launches[1].time_range.start,
                                   last is not None and last < launches[-1].time_range.start))
                    per_call.append(sum(ev.time_range.end - ev.time_range.start for ev in kernels) / 1e4)
                short = [c for c in counts if c[0] < c[1]]
                print(f"trace {mode} {name}: kernel records per trace {min(c[0] for c in counts)}-"
                      f"{max(c[0] for c in counts)}, traces with fewer kernel records than host launch records "
                      f"{len(short)}/100, of them the first call's record missing {sum(c[2] for c in short)}, the "
                      f"last call's {sum(c[3] for c in short)} (the first: {short[:5]}); device ms per call min "
                      f"{min(per_call):.4f} median {float(np.median(per_call)):.4f} max {max(per_call):.4f}",
                      flush=True)
    if "mel" in what.split(","):
        from chip_smoke import mel_errors, speech
        from huggingface_asr_tpu_torch.kernels import mel as K3
        from huggingface_asr_tpu_torch.ops.features import LogMelConfig

        cfg = LogMelConfig()
        fe = K3.MelFrontEnd(cfg, device=dev)
        rng = np.random.default_rng(0)
        S = 160000
        wav = np.zeros((128, S), np.float32)
        for i in range(128):
            w_ = speech(10.0 - 0.05 * (i % 16), rng)
            wav[i, :len(w_)] = w_
        wav = torch.from_numpy(wav).to(dev)
        n = int(cfg.num_frames(S))
        args = (cfg.hop_length, cfg.mel_floor)
        for B in (8, 128):
            x = wav[:B]
            kernel = lambda: K3.log_mel(x, n, fe.dft, fe.mel, *args)  # noqa: E731
            library = lambda: K3.log_mel_plain(x, n, fe.dft, fe.mel, *args)  # noqa: E731
            got, ref = kernel(), library()
            err = float((got - ref).abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= 1e-4 * max(1.0, float(ref.abs().max()))
            gate = []
            for name, xs in (("speech", x), ("quiet", x * 1e-4)):  # against the folded product in fp64
                err_k, err_p = mel_errors(K3, xs, n, fe, cfg)
                ok = ok and err_k <= 2 * err_p
                gate.append(f"{name} {err_k:.3e}/{err_p:.3e}")
            with torch.no_grad():
                print(f"mel B={B}: err={err:.3e} fp64 kernel/cublas: {', '.join(gate)} {'ok' if ok else 'FAIL'} "
                      f"ms={timed(kernel):.4f} device_ms={device_ms(kernel):.4f} "
                      f"cublas_fp32_device_ms={device_ms(library):.4f}", flush=True)
    for mode in what.split(","):
        if mode.split(":")[0] == "melbf16":
            melbf16_variant(csrc, dev, [int(b) for b in mode.split(":")[1:]] or [80])
        if mode.split(":")[0] == "melerr":
            melerr_variant(dev, [int(b) for b in mode.split(":")[1:]] or [80])
    if "geluserving" in what.split(","):
        geluserving_variant(dev)
    if "conv1" in what.split(",") or "cmvn" in what.split(","):
        import torch.nn.functional as F

        from chip_smoke import bound
        from huggingface_asr_tpu_torch.kernels import mel as K3

        C, n_mel, T_in = 256, 80, 998
        gen = torch.Generator().manual_seed(10)
        w1 = (torch.randn(9, C, generator=gen) / 3).bfloat16().to(dev)
        b1 = (torch.randn(C, generator=gen) * 0.1).bfloat16().float().to(dev)
        w_lib = w1.t().reshape(C, 1, 3, 3).contiguous()
        lm_all = (torch.randn(128, T_in, n_mel, generator=gen) * 2.0 - 3.0).to(dev)
        n_all = torch.tensor(smoke_lengths(128, T_in), dtype=torch.int32, device=dev)
        for B in (8, 128):
            lm, n = lm_all[:B].contiguous(), n_all[:B].contiguous()
            feats = K3.cmvn_plain(lm, n)
            if "cmvn" in what.split(","):
                kernel = lambda: K3.cmvn(lm, n)  # noqa: E731
                got, ref = kernel().float(), feats.float()
                err = float((got - ref).abs().max())
                ok = bool(torch.isfinite(got).all()) and err <= 2 ** -7 * max(1.0, float(ref.abs().max()))
                ms_b, _ = bound(8.0 * lm.numel(), 6 * lm.numel(), "fp32")
                print(f"cmvn B={B} T={T_in}: err={err:.3e} {'ok' if ok else 'FAIL'} ms={timed(kernel):.4f} "
                      f"device_ms={device_ms(kernel):.4f} bound_ms={ms_b:.4f} "
                      f"cast_device_ms={device_ms(lambda: lm.to(torch.bfloat16)):.4f}", flush=True)
            if "conv1" in what.split(","):
                kernel = lambda: K2.conv1(feats, w1, b1)  # noqa: E731
                library = lambda: F.conv2d(feats[:, None], w_lib, stride=2, padding=1)  # noqa: E731
                got, ref = kernel(), K2.conv1_plain(feats, w1, b1)
                err = float((got.float() - ref.float()).abs().max())
                same = float((got.view(torch.int16) == ref.view(torch.int16)).float().mean())
                scale = max(1.0, float(ref.float().abs().max()))
                ok = bool(torch.isfinite(got.float()).all()) and err <= 2 ** -7 * scale
                T1 = (T_in - 1) // 2 + 1
                ms_b, _ = bound(2.0 * 9 * C * B * T1 * 40, 2 * feats.numel() + 2 * C * B * T1 * 40, "bf16")
                with torch.no_grad():
                    print(f"conv1 B={B} T_in={T_in}: err={err:.3e} bit-equal={same:.6f} {'ok' if ok else 'FAIL'} "
                          f"ms={timed(kernel):.4f} device_ms={device_ms(kernel):.4f} bound_ms={ms_b:.4f} "
                          f"conv2d_device_ms={device_ms(library):.4f} "
                          f"fill_device_ms={device_ms(lambda: got.fill_(1.0)):.4f}", flush=True)
            del feats
            torch.cuda.empty_cache()
    if "posq" in what.split(","):
        for H, hw, D in ((8, 32, 256), (4, 64, 192)):
            for M in (2048, 32768):
                gen = torch.Generator().manual_seed(M + hw)
                q_v = torch.randn(M, H * hw, generator=gen).bfloat16().to(dev)
                wp = (torch.randn(H, D, hw, generator=gen) * 0.2).bfloat16().to(dev)
                tab = K1.relpos_kernel_tables(256, D, device=dev)
                a = (q_v, wp, tab["rot_cos"], tab["rot_sin"], 256)
                kernel = lambda: K1.pos_query(*a)  # noqa: E731
                got, ref = kernel().float(), K1.pos_query_plain(*a).float()
                err = float((got - ref).abs().max())
                ok = bool(torch.isfinite(got).all()) and err <= 2 ** -7 * max(1.0, float(ref.abs().max()))
                qh, wt = q_v.view(M, H, hw).transpose(0, 1).contiguous(), wp.transpose(1, 2).contiguous()
                library = lambda: torch.bmm(qh, wt)  # noqa: E731
                print(f"pos_query H={H} hw={hw} D={D} M={M}: err={err:.3e} {'ok' if ok else 'FAIL'} "
                      f"ms={timed(kernel):.4f} device_ms={device_ms(kernel):.4f} bmm_device_ms={device_ms(library):.4f}",
                      flush=True)
    if "lngemm" in what.split(","):
        lngemm_variant(K1, dev)
    if "ln" in what.split(","):
        import torch.nn.functional as F

        for M in (2048, 32768):  # B = 8 and 128 x T_pad 256
            gen = torch.Generator().manual_seed(M)
            x = torch.randn(M, 256, generator=gen).bfloat16().to(dev)
            ln_g = (1.0 + 0.1 * torch.randn(256, generator=gen)).to(dev)
            ln_b = (0.1 * torch.randn(256, generator=gen)).to(dev)
            g16, b16 = ln_g.bfloat16(), ln_b.bfloat16()
            kernel = lambda: K1.layer_norm(x, ln_g, ln_b, 1e-5)  # noqa: E731
            library = lambda: F.layer_norm(x, (256,), g16, b16, 1e-5)  # noqa: E731
            got, ref = kernel().float(), K1.layer_norm_plain(x, ln_g, ln_b, 1e-5).float()
            err = float((got - ref).abs().max())
            ok = err <= 2 ** -7 * max(1.0, float(ref.abs().max()))
            print(f"layernorm M={M}: err={err:.3e} {'ok' if ok else 'FAIL'} ms={timed(kernel):.4f} "
                  f"device_ms={device_ms(kernel):.4f} layer_norm_device_ms={device_ms(library):.4f}", flush=True)
    if "conv2" in what.split(","):
        import torch.nn.functional as F

        for B, T1, T2 in CONV2_SHAPES:
            y1 = torch.randn(B, T1, 40, 256, generator=g).bfloat16().to(dev)
            w2 = (torch.randn(9 * 256, 256, generator=g) * 0.02).bfloat16().to(dev)
            b2 = (torch.randn(256, generator=g) * 0.1).bfloat16().float().to(dev)
            got = K2.conv2(y1, w2, b2, T2)
            verdict = "unchecked"
            if B <= 8:  # the plain version at B=128 needs tens of GB
                ref = K2.conv2_plain(y1, w2, b2, T2).float()
                err = float((got.float() - ref).abs().max())
                verdict = f"err={err:.3e} {'ok' if err <= tol * max(1.0, float(ref.abs().max())) else 'FAIL'}"
            # library call: F.conv2d in bf16 on the (B, C, T1, F1) view, without the bias and GELU
            w_lib = w2.reshape(3, 3, 256, 256).permute(3, 2, 0, 1).contiguous()
            library = lambda: F.conv2d(y1.permute(0, 3, 1, 2), w_lib, stride=2, padding=1)  # noqa: E731
            with torch.no_grad():
                print(f"conv2 B={B} T2={T2} rows={got.shape[0]} {verdict} "
                      f"ms={timed(lambda: K2.conv2(y1, w2, b2, T2)):.4f} "
                      f"device_ms={device_ms(lambda: K2.conv2(y1, w2, b2, T2)):.4f} "
                      f"conv2d_device_ms={device_ms(library):.4f}", flush=True)
            del y1, got
    if "k4" in what.split(","):
        for B, T, H, D, lens, rate in K4_SHAPES:
            g = torch.Generator().manual_seed(T)
            mk = lambda *s: torch.randn(*s, generator=g).bfloat16().to(dev)  # noqa: E731
            q_u, q_rot, k, v, k_std = mk(B, T, H, 32), mk(B, T, H, D) * 0.25, mk(B, T, H, 32), mk(B, T, H, 32), mk(T, D)
            lengths = torch.tensor(lens or smoke_lengths(B, T), dtype=torch.int32, device=dev)
            with torch.no_grad():
                call = lambda: rel_attention_train(q_u, q_rot, k, v, k_std, lengths, 77, rate)  # noqa: E731
                ref = rel_attention_train_plain(q_u, q_rot, k, v, k_std, lengths, 77, rate).float()
                err = float((call().float() - ref).abs().max())
                ok = err <= tol * max(1.0, float(ref.abs().max()))
                print(f"K4 fwd B={B} T={T} D={D} rate={rate} err={err:.3e} {'ok' if ok else 'FAIL'} "
                      f"ms={timed(call):.4f}", flush=True)
    if "k4bwd" in what.split(","):
        for B, T, H, D, lens, rate in K4BWD_SHAPES:
            g = torch.Generator().manual_seed(T)
            mk = lambda *s: torch.randn(*s, generator=g).bfloat16().to(dev)  # noqa: E731
            q_u, q_rot, k, v, k_std = mk(B, T, H, 32), mk(B, T, H, D) * 0.25, mk(B, T, H, 32), mk(B, T, H, 32), mk(T, D)
            cot = mk(B, T, H, 32)
            lengths = torch.tensor(lens or smoke_lengths(B, T), dtype=torch.int32, device=dev)

            def grads(fn):
                leaves = [t.clone().requires_grad_(True) for t in (q_u, q_rot, k, v)]
                out = fn(*leaves, k_std, lengths, 77, rate)
                return (lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True))

            call = grads(rel_attention_train)
            got, ref = call(), grads(rel_attention_train_plain)()
            torch.cuda.synchronize()
            errs = []
            for name, a, r in zip(("dq_u", "dq_rot", "dk", "dv"), got, ref):
                err = float((a.float() - r.float()).abs().max())
                ok = bool(torch.isfinite(a.float()).all()) and err <= tol * max(1.0, float(r.float().abs().max()))
                errs.append(f"{name}={err:.2e}{'' if ok else ' FAIL'}")
            print(f"K4 bwd B={B} T={T} D={D} rate={rate} {' '.join(errs)} ms={timed(call):.4f} "
                  f"device_ms={device_ms(call):.4f}", flush=True)
    if "k4wide" in what.split(","):
        from chip_smoke import bound, device_kernel_ms, nbytes, sdpa_call
        from huggingface_asr_tpu_torch.kernels import train_attention as TA

        if "asr_rel_attention_train_bwd_fp32" not in (pathlib.Path(csrc) / "rel_attention_train.cu").read_text():
            legacy_fp32_backward(TA)
        for dtype_name, B, dh, D in K4WIDE_CASES:
            dtype = getattr(torch, dtype_name)
            gen = torch.Generator().manual_seed(B + D)
            mk = lambda *s: torch.randn(*s, generator=gen).to(dtype).to(dev)  # noqa: E731
            H, T = 8, 250
            q_u, q_rot, k, v, k_std, cot = (mk(B, T, H, dh), mk(B, T, H, D) * 0.25, mk(B, T, H, dh), mk(B, T, H, dh),
                                            mk(T, D), mk(B, T, H, dh))
            lens = smoke_lengths(B, T)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            kind = "bf16" if dtype == torch.bfloat16 else "fp32"
            label = f"K4 {kind} dh={dh} D={D} B={B} T={T} rate=0.1"

            def run(fn):
                leaves = [t.clone().requires_grad_(True) for t in (q_u, q_rot, k, v)]
                out = fn(*leaves, k_std, lengths, 77, 0.1)
                return out, leaves

            out, leaves = run(rel_attention_train)
            bwd = lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)  # noqa: E731
            fwd = lambda: rel_attention_train(q_u, q_rot, k, v, k_std, lengths, 77, 0.1)  # noqa: E731
            try:
                got = [out.detach()] + list(bwd())
            except RuntimeError as e:  # a tree whose backward does not take this width
                print(f"{label}: the backward refused by this tree ({str(e)[:120]})", flush=True)
                continue
            ref_out, ref_leaves = run(rel_attention_train_plain)
            errs = []
            att_tol = 2 ** -6 if dtype == torch.bfloat16 else 1e-4
            for name, a, r in zip(("out", "dq_u", "dq_rot", "dk", "dv"), got,
                                  [ref_out.detach()] + list(torch.autograd.grad(ref_out, ref_leaves, cot))):
                err = float((a.float() - r.float()).abs().max())
                ok = bool(torch.isfinite(a.float()).all()) and err <= att_tol * max(1.0, float(r.float().abs().max()))
                errs.append(f"{name}={err:.2e}{'' if ok else ' FAIL'}")
            del ref_out, ref_leaves
            # bounds as chip_smoke.py counts them: the visited keys' products, each operand and result once
            n_keys = float(sum(n if n > 0 else T for n in lens))
            small, big, rest = nbytes(q_u), nbytes(q_rot), nbytes(k_std) + 8 * B * H * T
            fwd_bound = bound(2.0 * H * T * n_keys * (2 * dh + D), 4 * small + big + rest, kind)[0]
            bwd_bound = bound(2.0 * H * T * n_keys * (5 * dh + 2 * D), 7 * small + 2 * big + rest, kind)[0]
            lib_fwd, lib_make_bwd = sdpa_call(q_u, q_rot, k, v, k_std, lengths, 1.0 / float(np.sqrt(dh)))
            with torch.no_grad():
                fwd_line = (f"fwd ms={timed(fwd, 5):.4f} device_ms={device_ms(fwd, name='train_fwd_'):.4f} "
                            f"bound_ms={fwd_bound:.4f} sdpa_device_ms={device_ms(lib_fwd):.4f}")
            # the backward's device time by kernel (the fp32 tree of this file: delta, dk/dv, dq)
            by_kernel = {re.search(r"train_\w+", name).group(0): round(ms, 4)
                         for name, ms in device_kernel_ms(bwd).items() if "train_bwd_" in name}
            print(f"{label} {' '.join(errs)} {fwd_line} bwd ms={timed(bwd, 5):.4f} "
                  f"device_ms={sum(by_kernel.values()):.4f} {by_kernel} bound_ms={bwd_bound:.4f} "
                  f"sdpa_device_ms={device_ms(lib_make_bwd()):.4f}", flush=True)
            del out, leaves, lib_fwd, lib_make_bwd
            torch.cuda.empty_cache()
    if "k5fp32" in what.split(","):
        from chip_smoke import bound, nbytes, sdpa_call

        for dtype_name, B, dh in K5FP32_CASES:
            dtype = getattr(torch, dtype_name)
            gen = torch.Generator().manual_seed(B + dh)
            mk = lambda *s: torch.randn(*s, generator=gen).to(dtype).to(dev)  # noqa: E731
            H, T, D = 8, 250, 8 * dh  # D: the config's width, the q_rot of the SDPA yardstick
            lens = smoke_lengths(B, T)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            args = (mk(B, T, H, dh), mk(B, T, H, dh), mk(B, T, H, dh), mk(B, T, H, dh), mk(2 * T - 1, H, dh), lengths)
            call = lambda: rel_attention(*args)  # noqa: E731
            kind = "bf16" if dtype == torch.bfloat16 else "fp32"
            with torch.no_grad():
                ref = rel_attention_plain_shift(*args).float()
                err = float((call().float() - ref).abs().max())
                ok = err <= (2 ** -6 if kind == "bf16" else 1e-4) * max(1.0, float(ref.abs().max()))
                del ref
                # the bound as chip_smoke.py counts it: the visited keys' three products, each operand once
                n_keys = float(sum(n if n > 0 else T for n in lens))
                bound_ms = bound(2.0 * H * T * n_keys * 3 * dh, 5 * nbytes(args[0]) + nbytes(args[4]), kind)[0]
                lib = sdpa_call(args[0], mk(B, T, H, D) * 0.25, args[2], args[3], mk(T, D), lengths,
                                1.0 / float(np.sqrt(dh)))[0]
                print(f"K5 {kind} dh={dh} B={B} T={T} err={err:.3e} {'ok' if ok else 'FAIL'} ms={timed(call):.4f} "
                      f"device_ms={device_ms(call, name='shift_'):.4f} bound_ms={bound_ms:.4f} "
                      f"sdpa_device_ms={device_ms(lib):.4f}", flush=True)
            del args, lib
            torch.cuda.empty_cache()
        import dataclasses
        import time

        from chip_smoke import WIDE_CONFIG, config_file, device_kernel_ms, seeded_model

        cfg = dataclasses.replace(config_file(WIDE_CONFIG), attention_impl="pallas", vocab_size=500)
        model = seeded_model(cfg, seed=2).to(dev)
        gen = torch.Generator().manual_seed(16)
        feats = torch.randn(16, 998, cfg.num_fbanks, generator=gen).to(dev)
        feat_lens = torch.tensor([998 - 20 * i for i in range(16)], dtype=torch.int32, device=dev)
        forward = lambda: model(feats, feat_lens)  # noqa: E731
        with torch.no_grad():
            _build.reset_launch_counts()
            forward()
            torch.cuda.synchronize()
            k5_launches = _build.LAUNCHES["asr_rel_attention_shift"]
            host = []
            for _ in range(3):
                t_ = time.perf_counter()
                forward()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t_) * 1e3)
            per_kernel = device_kernel_ms(forward, 2)
        k5_ms = sum(v for k, v in per_kernel.items() if "shift_" in k)
        print(f"512-wide fp32 forward B=16 x 998 frames ('pallas'): K5 launches {k5_launches}, host "
              f"{float(np.median(host)):.1f} ms, device {sum(per_kernel.values()):.2f} ms, of it K5 {k5_ms:.3f} ms",
              flush=True)
        del model
        torch.cuda.empty_cache()
    if "yardsticks" in what.split(","):
        import torch.nn.functional as F

        from chip_smoke import sdpa_call

        # rel_attention (flagship: 8 heads of 32, q_rot 256) at a B=8 x 10 s request, both profiles, beside SDPA
        B, T, H, D = 8, 256, 8, 256
        gen = torch.Generator().manual_seed(8)
        mk = lambda *s: torch.randn(*s, generator=gen).bfloat16().to(dev)  # noqa: E731
        q_u, k, v, q_rot, k_std = mk(B, T, H, 32), mk(B, T, H, 32), mk(B, T, H, 32), mk(B, T, H, D) * 0.25, mk(T, D)
        lengths = torch.tensor([250 - 12 * i for i in range(B)], dtype=torch.int32, device=dev)
        att = (q_u, k, v, q_rot, k_std, lengths)
        lib = sdpa_call(q_u, q_rot, k, v, k_std, lengths, 1.0)[0]
        with torch.no_grad():
            print(f"rel_attention B={B} T_pad={T} device_ms serving="
                  f"{device_ms(lambda: K1.rel_attention(*att, profile='serving')):.4f} "
                  f"exact={device_ms(lambda: K1.rel_attention(*att)):.4f} sdpa_device_ms={device_ms(lib):.4f}",
                  flush=True)
        # the 176-wide config's FF1-in with its GELU (K = 176, N = 704) at M = 2,048, beside F.linear
        M, K, N = 2048, 176, 704
        a, w = mk(M, K), mk(K, N) * 0.1
        bias = torch.randn(N, generator=gen).to(dev)
        w_t, b16 = w.t().contiguous(), bias.bfloat16()
        with torch.no_grad():
            kernel_ms = device_ms(lambda: K1.gemm(a, w, bias, act="gelu"))
            print(f"gemm ff1_in+gelu M={M} K={K} N={N} device_ms={kernel_ms:.4f} "
                  f"linear_device_ms={device_ms(lambda: F.linear(a, w_t, b16)):.4f}", flush=True)
    if "k1" in what.split(","):
        for B, T, H, D, lens in K1_SHAPES:
            g = torch.Generator().manual_seed(T)
            mk = lambda *s: torch.randn(*s, generator=g).bfloat16().to(dev)  # noqa: E731
            qkv, q_rot, k_std = mk(B * T, 3 * H * 32), mk(B, T, H, D) * 0.25, mk(T, D)
            # column views of one buffer, as the layer passes them
            q_u, k, v = (qkv[:, i * H * 32:(i + 1) * H * 32].view(B, T, H, 32) for i in range(3))
            lengths = torch.tensor(lens or smoke_lengths(B, T), dtype=torch.int32, device=dev)
            call = lambda: K1.rel_attention(q_u, k, v, q_rot, k_std, lengths)  # noqa: E731
            verdict = "unchecked"
            if B <= 8:
                ref = K1.rel_attention_plain(q_u, k, v, q_rot, k_std, lengths).float()
                err = float((call().float() - ref).abs().max())
                verdict = f"err={err:.3e} {'ok' if err <= tol * max(1.0, float(ref.abs().max())) else 'FAIL'}"
            print(f"K1 rel_attention B={B} T_pad={T} D={D} {verdict} ms={timed(call):.4f}", flush=True)
            if (B, T) == (2, 64):
                print(f"K1 rel_attention host us per launch: {host_us_per_launch(call):.2f}", flush=True)
    if "k5" in what.split(","):
        for B, T, H, lens in K5_SHAPES:
            g = torch.Generator().manual_seed(T)
            mk = lambda *s: torch.randn(*s, generator=g).bfloat16().to(dev)  # noqa: E731
            args = [mk(B, T, H, 32), mk(B, T, H, 32), mk(B, T, H, 32), mk(B, T, H, 32), mk(2 * T - 1, H, 32),
                    torch.tensor(lens or smoke_lengths(B, T), dtype=torch.int32, device=dev)]
            call = lambda: rel_attention(*args)  # noqa: E731
            ref = rel_attention_plain_shift(*args).float()
            err = float((call().float() - ref).abs().max())
            ok = err <= tol * max(1.0, float(ref.abs().max()))
            print(f"K5 shift B={B} T={T} err={err:.3e} {'ok' if ok else 'FAIL'} ms={timed(call):.4f}", flush=True)
            if T == 70:
                print(f"K5 shift host us per launch: {host_us_per_launch(call):.2f}", flush=True)


def main() -> None:
    if sys.argv[1] == "--one":
        run_variant(sys.argv[2], sys.argv[3])
        return
    args = sys.argv[1:]
    out = None
    if args[0] == "--out":  # also append every variant's full output to this file
        out, args = open(args[1], "a"), args[2:]
    what, dirs = args[0], args[1:]

    def emit(text: str, full: str = None) -> None:
        print(text, flush=True)
        if out is not None:
            out.write((full or text) + "\n")
            out.flush()

    emit(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                        capture_output=True, text=True, check=True).stdout.strip())
    failed = False
    for d in (dirs + dirs[::-1] if len(dirs) > 1 else dirs):
        res = subprocess.run([sys.executable, __file__, "--one", d, what], capture_output=True, text=True,
                             timeout=600)
        emit(f"=== {d} rc={res.returncode}\n{res.stdout[-12000:]}\n{res.stderr[-2500:]}",
             f"=== {d} rc={res.returncode}\n{res.stdout}\n{res.stderr[-2500:]}")
        failed = failed or res.returncode != 0 or "FAIL" in res.stdout
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
