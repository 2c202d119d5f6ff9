"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of huggingface_asr_tpu_torch/csrc with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   flagship shapes (B=8, 10 s -> T_in=998 mel frames, T_pad=256 encoder
   frames; and 20 s, T_pad=504), with TF32 off for the plain reference, and
   times both with CUDA events (median of 5 windows of 20 kernel calls);
4. writes a flagship E-Branchformer CTC model with seeded random weights
   (12 layers, D=256, 8 heads, I=1024, 256x256 subsampler, 500+1 outputs),
   loads it through ASRPipeline(device="cuda") and answers requests of 1, 4
   and 8 seeded synthetic utterances in the 5 s, 10 s and 20 s buckets, each
   timed once on the host clock;
5. checks that every kernel of the path launched during those requests, and
   that for every request the kernel path's logits and greedy ids match the
   plain path's on the card.

It prints one JSON line with every kernel's launches, error and times, then
the result line {"ok": true, "device": {...}} last. It exits non-zero without
a result line when CUDA is missing or any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def speech(seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Seeded synthetic speech at 16 kHz: two-formant tone bursts of 80-160 ms
    with pauses, a random gain and a little noise."""
    n = int(seconds * 16000)
    out = np.zeros(n, np.float32)
    pos = 0
    while pos < n:
        dur = int(rng.uniform(0.08, 0.16) * 16000)
        t = np.arange(dur) / 16000
        seg = np.zeros(dur)
        if rng.random() > 0.15:
            f1, f2 = rng.uniform(300, 1200), rng.uniform(1200, 3500)
            seg = (0.6 * np.sin(2 * np.pi * f1 * t) + 0.4 * np.sin(2 * np.pi * f2 * t)) * np.hanning(dur)
        m = min(dur, n - pos)
        out[pos:pos + m] = seg[:m]
        pos += dur
    noise = rng.standard_normal(n).astype(np.float32) * 0.02
    return (out * rng.uniform(0.5, 1.0) + noise).astype(np.float32)


def flagship_model(seed: int = 0):
    """The flagship E-Branchformer CTC (12 layers, D=256, 8 heads, I=1024,
    256x256 subsampler, 500+1 outputs) with weights drawn from ``seed``."""
    import torch

    sys.path.insert(0, ROOT)
    from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
    from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC, init_random_

    cfg = EBranchformerConfig(
        hidden_size=256, num_hidden_layers=12, num_attention_heads=8, intermediate_size=1024,
        conv_dim=(256, 256), conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1),
        vocab_size=500,
    )
    return init_random_(EBranchformerForCTC(cfg).eval(), torch.Generator().manual_seed(seed))


def timed(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` windows of the mean ms of ``iters`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / iters)
    return float(np.median(windows))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    sys.path.insert(0, ROOT)
    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.kernels import layer as K1
    from huggingface_asr_tpu_torch.kernels import mel as K3
    from huggingface_asr_tpu_torch.kernels import subsample as K2
    from huggingface_asr_tpu_torch.models.ebranchformer import feat_extract_output_frames
    from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from huggingface_asr_tpu_torch.training.model_factory import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds})", flush=True)
    log = (_build.BUILD_DIR / "build.log").read_text()
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill stores" in line:
            print("  ptxas:", line.strip())

    model = flagship_model(seed=0)
    cfg = model.config
    fused = FusedCTC(model, dev)
    mel_cfg = LogMelConfig(num_mel_bins=cfg.num_fbanks)
    frontend = K3.MelFrontEnd(mel_cfg, device=dev)

    results = {}
    failures = []

    def compare(name, key, kernel_fn, plain_fn, rel_tol, iters=20):
        """Kernel vs plain on the same inputs; times are medians of 5 windows
        (``iters`` kernel calls, ``iters // 4`` plain calls each). The JSON line
        keeps, per key, the largest error over both buckets and the 10 s
        bucket's times."""
        got = kernel_fn()
        ref = plain_fn()
        torch.cuda.synchronize()
        g = (got if isinstance(got, torch.Tensor) else got[0]).float()
        r = (ref if isinstance(ref, torch.Tensor) else ref[0]).float()
        finite = bool(torch.isfinite(g).all())
        err = float((g - r).abs().max())
        tol = rel_tol * max(1.0, float(r.abs().max()))
        ms = timed(kernel_fn, iters)
        plain_ms = timed(plain_fn, max(2, iters // 4))
        ok = finite and err <= tol
        print(f"  {name:28s} max_abs_err={err:.3e} tol={tol:.3e} kernel={ms:.4f} ms "
              f"plain={plain_ms:.4f} ms {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
        if key is not None:
            entry = results.setdefault(key, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if "ms" not in entry:  # the 10 s bucket runs first
                entry.update(ms=ms, plain_ms=plain_ms)
        return got

    rng = np.random.default_rng(0)
    for seconds in (10.0, 20.0):
        B = 8
        S = int(seconds * 16000)
        wavs = np.zeros((B, S), np.float32)
        lens = np.asarray([S - int(i * 0.05 * S) for i in range(B)], np.int32)
        for i in range(B):
            wavs[i, : lens[i]] = speech(lens[i] / 16000, rng)
        wav = torch.from_numpy(wavs).to(dev)
        wav_lens = torch.from_numpy(lens).to(dev)
        n_frames = int(mel_cfg.num_frames(S))
        T = int(feat_extract_output_frames(cfg, n_frames))
        T_pad = -(-T // 8) * 8
        print(f"-- B={B}, {seconds:.0f} s: T_in={n_frames}, T={T}, T_pad={T_pad}", flush=True)

        # K3
        hop, floor = mel_cfg.hop_length, mel_cfg.mel_floor
        lm = compare("mel", "mel", lambda: K3.log_mel(wav, n_frames, frontend.dft, frontend.mel, hop, floor),
                     lambda: K3.log_mel_plain(wav, n_frames, frontend.dft, frontend.mel, hop, floor),
                     1e-4)
        feat_lens = torch.clamp(mel_cfg.num_frames(wav_lens.long()), 0, n_frames).int()
        feats = compare("cmvn", "cmvn", lambda: K3.cmvn(lm, feat_lens), lambda: K3.cmvn_plain(lm, feat_lens),
                        2 ** -7)

        # K2
        sw = fused.subsample
        y1 = compare("conv1", "conv1", lambda: K2.conv1(feats, sw["w1"], sw["b1"]),
                     lambda: K2.conv1_plain(feats, sw["w1"], sw["b1"]), 2 ** -7)
        compare("conv2", "conv2", lambda: K2.conv2(y1, sw["w2"], sw["b2"], T_pad),
                lambda: K2.conv2_plain(y1, sw["w2"], sw["b2"], T_pad), 2 ** -6)
        hidden = compare("subsample (K2 whole)", None, lambda: K2.conv_subsample(feats, sw, cfg, T_pad),
                         lambda: K2.conv_subsample_plain(feats, sw, cfg, T_pad), 0.05)

        # K1 pieces at this bucket's shapes, with the real folded weights of layer 0
        w = fused.layers[0]
        tables = fused.tables(T_pad)
        enc_lens = torch.clamp(feat_extract_output_frames(cfg, feat_lens.long()), 0, T).int()
        mask = torch.arange(T_pad, device=dev)[None, :] < enc_lens[:, None]
        x = torch.where(mask[..., None], hidden, 0.0).to(torch.bfloat16).contiguous()
        M, D, H = B * T_pad, cfg.hidden_size, cfg.num_attention_heads
        xf = x.view(M, D)
        g = compare("layernorm", "layernorm", lambda: K1.layer_norm(xf, w["attn_ln_g"], w["attn_ln_b"], 1e-5),
                    lambda: K1.layer_norm_plain(xf, w["attn_ln_g"], w["attn_ln_b"], 1e-5), 2 ** -7)
        compare("gemm ff1_in (+gelu)", "gemm", lambda: K1.gemm(g, w["ff1_wi"], w["ff1_bi"], act="gelu"),
                lambda: K1.gemm_plain(g, w["ff1_wi"], w["ff1_bi"], act="gelu"), 2 ** -6)
        h = K1.gemm(g, w["ff1_wi"], w["ff1_bi"], act="gelu")
        compare("gemm ff1_out (+residual)", "gemm",
                lambda: K1.gemm(h, w["ff1_wo"], w["ff1_bo"], residual=xf, alpha=0.5),
                lambda: K1.gemm_plain(h, w["ff1_wo"], w["ff1_bo"], residual=xf, alpha=0.5), 2 ** -6)
        qkv, q_v = compare("gemm qkv (dual bias)", "gemm",
                           lambda: K1.gemm(g, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"]),
                           lambda: K1.gemm_plain(g, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"]),
                           2 ** -6)
        q_v_ref = K1.gemm_plain(g, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])[1]
        err_qv = float((q_v.float() - q_v_ref.float()).abs().max())
        print(f"  {'gemm qkv second output':28s} max_abs_err={err_qv:.3e}")
        if err_qv > 2 ** -6 * max(1.0, float(q_v_ref.float().abs().max())):
            failures.append("gemm qkv second output")
        q_rot = compare("pos_query", "pos_query",
                        lambda: K1.pos_query(q_v, w["wp_e"], w["wp_o"], tables["rot_cos"],
                                             tables["rot_sin"], T_pad),
                        lambda: K1.pos_query_plain(q_v, w["wp_e"], w["wp_o"], tables["rot_cos"],
                                                   tables["rot_sin"], T_pad),
                        2 ** -7)
        hv = lambda i: qkv[:, i * D:(i + 1) * D].view(B, T_pad, H, D // H)
        qr = q_rot.view(B, T_pad, H, D)
        compare("rel_attention", "rel_attention",
                lambda: K1.rel_attention(hv(0), hv(1), hv(2), qr, tables["k_std"], enc_lens),
                lambda: K1.rel_attention_plain(hv(0), hv(1), hv(2), qr, tables["k_std"], enc_lens),
                2 ** -6)
        l = K1.gemm(K1.layer_norm(xf, w["cg_ln_g"], w["cg_ln_b"], 1e-5), w["cg_w1"], w["cg_b1"],
                    act="gelu")
        args = (w["csgu_ln_g"], w["csgu_ln_b"], w["csgu_dw"], w["csgu_dw_b"], B, T_pad, T,
                cfg.csgu_activation, 1e-5)
        compare("dwconv csgu", "dwconv_csgu", lambda: K1.csgu(l, *args), lambda: K1.csgu_plain(l, *args), 2 ** -7)
        merged = torch.cat([xf, xf], dim=1).contiguous()
        margs = (w["merge_dw"], w["merge_dw_b"], B, T_pad, T)
        compare("dwconv merge", "dwconv_merge", lambda: K1.merge_conv(merged, *margs),
                lambda: K1.merge_conv_plain(merged, *margs), 2 ** -7)
        compare("layer (K1 whole)", None,
                lambda: K1.ebranchformer_layer(x, enc_lens, w, cfg, T, tables),
                lambda: K1.ebranchformer_layer_plain(x, enc_lens, w, cfg, T, tables), 0.05)

    # ---- the main path: ASRPipeline on the card
    model_dir = os.path.join(ROOT, "build", "chip_smoke_model")
    save_checkpoint(model, model_dir)

    class PieceTable:
        """id -> piece decoding for the random model's 500 outputs."""

        def decode(self, ids, skip_special_tokens=True):
            return "".join(chr(ord("a") + i % 26) if i % 7 else " " for i in ids)

    pipe = ASRPipeline(model_dir, model_type="ctc", device="cuda", tokenizer=PieceTable())
    if not pipe._use_fused:
        _fail("pipeline did not select the fused kernel path")
    requests = {
        "1 utt (4 s)": [speech(4.0, rng)],
        "4 utts (6-18 s)": [speech(s, rng) for s in (6.0, 9.5, 13.0, 18.0)],
        "8 utts (3-10 s)": [speech(3.0 + s, rng) for s in np.linspace(0, 7, 8)],
    }
    pipe(requests["1 utt (4 s)"])  # first call: warm the allocator
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for name, audios in requests.items():
        t = time.perf_counter()
        texts = pipe(audios)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if len(texts) != len(audios):
            _fail(f"{name}: {len(texts)} transcripts for {len(audios)} utterances")
        print(f"request {name}: {ms:.1f} ms; transcripts: {[s[:40] for s in texts]}", flush=True)
    launches = dict(_build.LAUNCHES)
    print(f"launches in the pipeline phase: {launches}", flush=True)
    needed = ["asr_log_mel", "asr_cmvn", "asr_conv1", "asr_conv2", "asr_gemm_bf16",
              "asr_layernorm_bf16", "asr_pos_query", "asr_rel_attention", "dwconv_csgu",
              "dwconv_merge"]
    missing = [k for k in needed if launches.get(k, 0) <= 0]
    if missing:
        _fail(f"kernels not launched on the main path: {missing}")

    # ---- kernel path vs plain path on the card, every request (same waveforms).
    # Logits within 0.05 of their scale (the tolerance the JAX package holds its
    # Pallas path to); greedy ids equal on every frame where the plain path's
    # top-2 margin exceeds twice that tolerance, and on >= 98 % of all valid
    # frames (random weights leave many near-ties).
    n_frames = n_agree = 0
    for name, audios in requests.items():
        wav = torch.from_numpy(pipe._bucket_pad(audios)).to(dev)
        lens = torch.tensor([len(a) for a in audios], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            got = ctc_infer(pipe._fused, *pipe._frontend(wav, lens))
            ref = ctc_infer(pipe._fused, *pipe._frontend(wav, lens, plain=True), plain=True)
        torch.cuda.synchronize()
        g, r = got.logits.float(), ref.logits.float()
        if g.shape != r.shape or g.shape[:2] != (len(audios), r.shape[1]) \
                or g.shape[-1] != cfg.vocab_size + 1:
            _fail(f"{name}: logit shapes {tuple(g.shape)} vs {tuple(r.shape)}")
        if not torch.equal(got.logit_lengths, ref.logit_lengths):
            _fail(f"{name}: logit lengths differ")
        valid = torch.arange(g.shape[1], device=dev)[None, :] < ref.logit_lengths[:, None]
        err = float((g - r).abs()[valid].max())
        scale = float(r.abs()[valid].max())
        tol = 0.05 * max(1.0, scale)
        same = (g.argmax(-1) == r.argmax(-1))[valid]
        top2 = r.topk(2, dim=-1).values
        clear = ((top2[..., 0] - top2[..., 1]) > 2 * tol)[valid]
        n_frames += int(valid.sum())
        n_agree += int(same.sum())
        print(f"{name} logits kernel vs plain: max_abs_err={err:.3e} tol={tol:.3e} "
              f"(scale {scale:.3f}); greedy ids agree on {float(same.float().mean()):.4f} of "
              f"{int(valid.sum())} valid frames, on {int((same & clear).sum())}/{int(clear.sum())} "
              f"frames with a clear margin", flush=True)
        if not bool(torch.isfinite(g).all()) or err > tol:
            _fail(f"{name}: pipeline logits disagree with the plain path")
        if not bool(same[clear].all()):
            _fail(f"{name}: greedy ids differ on a frame with a clear margin")
    if n_agree < 0.98 * n_frames:
        _fail(f"greedy ids agree on {n_agree}/{n_frames} valid frames, below 98 %")

    if failures:
        _fail(f"kernel phases outside tolerance: {failures}")

    routes = {
        "mel": ("asr_log_mel", "csrc/mel.cu", "huggingface_asr_tpu/ops/pallas_features.py:112"),
        "cmvn": ("asr_cmvn", "csrc/mel.cu", "huggingface_asr_tpu/ops/pallas_features.py:112"),
        "conv1": ("asr_conv1", "csrc/subsample.cu", "huggingface_asr_tpu/ops/pallas_subsample.py:147"),
        "conv2": ("asr_conv2", "csrc/subsample.cu", "huggingface_asr_tpu/ops/pallas_subsample.py:147"),
        "gemm": ("asr_gemm_bf16", "csrc/gemm.cuh", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "layernorm": ("asr_layernorm_bf16", "csrc/layer.cu", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "pos_query": ("asr_pos_query", "csrc/layer.cu", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "rel_attention": ("asr_rel_attention", "csrc/rel_attention.cu",
                          "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "dwconv_csgu": ("dwconv_csgu", "csrc/dwconv.cu", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "dwconv_merge": ("dwconv_merge", "csrc/dwconv.cu", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
    }
    kernels = []
    for name, (counter, src, replaces) in routes.items():
        kernels.append({
            "name": name, "route": "cuda", "source": f"huggingface_asr_tpu_torch/{src}",
            "replaces": replaces, "launches": launches[counter], **results[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
