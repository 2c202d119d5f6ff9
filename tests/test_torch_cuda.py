"""PyTorch port: each CUDA kernel against its plain version on the card.

Imports neither jax nor the JAX package, so the file also runs on a machine
with only PyTorch and a GPU:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Every test skips where there is no CUDA device. Plain references run in fp32
with TF32 off. Tolerances: pieces with the kernel's own rounding points may
differ by an fp32 summation order, i.e. an isolated bf16 ulp (2^-7 or 2^-6 of
the scale); chains of pieces (a layer, the subsampler, the model) 0.05 of the
scale, as the JAX package holds its Pallas path to its XLA path.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from huggingface_asr_tpu_torch.data.synthetic_speech import utterance
from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels import layer as K1
from huggingface_asr_tpu_torch.kernels import mel as K3
from huggingface_asr_tpu_torch.kernels import subsample as K2
from huggingface_asr_tpu_torch.kernels.attention import rel_attention, rel_attention_plain_shift
from huggingface_asr_tpu_torch.kernels.train_attention import (
    rel_attention_train,
    rel_attention_train_plain,
)
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC, init_from_scratch_, init_random_
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer
from huggingface_asr_tpu_torch.ops.features import LogMelConfig

pytestmark = pytest.mark.cuda

CFG = EBranchformerConfig(
    hidden_size=128, num_hidden_layers=2, num_attention_heads=4, intermediate_size=256,
    csgu_kernel_size=7, merge_conv_kernel=7, vocab_size=50,
)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, rel):
    g, r = got.float(), ref.float()
    assert bool(torch.isfinite(g).all())
    err, scale = float((g - r).abs().max()), max(1.0, float(r.abs().max()))
    assert err <= rel * scale, (err, rel * scale)


@pytest.fixture(scope="module")
def fused():
    model = init_random_(EBranchformerForCTC(CFG).eval(), torch.Generator().manual_seed(0))
    return model, FusedCTC(model, "cuda") if torch.cuda.is_available() else None


def test_mel_and_cmvn():
    dev = _cuda()
    rng = np.random.default_rng(0)
    wav = torch.from_numpy(rng.standard_normal((3, 16000 * 3)).astype(np.float32) * 0.1).to(dev)
    fe = K3.MelFrontEnd(LogMelConfig(), device=dev)
    lm = K3.log_mel(wav, 298, fe.dft, fe.mel, 160, 2 ** -23)
    _close(lm, K3.log_mel_plain(wav, 298, fe.dft, fe.mel, 160, 2 ** -23), 1e-4)
    n = torch.tensor([298, 180, 0], dtype=torch.int32, device=dev)
    out = K3.cmvn(lm, n)
    _close(out, K3.cmvn_plain(lm, n), 2 ** -7)
    assert bool((out[1, 180:] == 0).all())


def _speech_batch(B, S, seed):
    """B seeded synthetic utterances of S samples (the last ones shorter,
    zero-padded), fp32 numpy."""
    rng = np.random.default_rng(seed)
    wav = np.zeros((B, S), np.float32)
    for i in range(B):
        w = utterance((S - i * (S // (4 * B))) / 16000, rng)[0]
        wav[i, :len(w)] = w
    return wav


@pytest.mark.parametrize("B,S", [(1, 16000 * 2 + 3), (3, 16000 * 3 + 1), (8, 160000 + 2), (24, 160000 + 2)])
@pytest.mark.parametrize("quiet", [False, True])
@pytest.mark.parametrize("mode", K3.MEL_MODES)
@pytest.mark.parametrize("n_mel", [1, 10, 11, 23, 80, 128])
def test_mel_kernel_against_fp64(n_mel, mode, B, S, quiet):
    """The log-mel kernel of each DFT mode at 1, 10, 11, 23, 80 and 128 mel
    bins (1, 10, 11: filters whose run spans more than two passes of 64 bins,
    which the bf16 kernel sums in segments through its carry slots; 23: no
    multiple of 8; 128: the bank's filter 3 is empty, its column the constant
    log(mel_floor)), on speech-like input and on the same input x 1e-4 (bins
    near the mel floor), at an S that is no multiple of 4 (utterance rows not
    16-byte aligned): against the folded product in fp64 (the plain version
    on float64 operands), the kernel's largest log-mel error is at most
    twice the fp32 plain version's (cuBLAS, TF32 off) in "highest", and at
    most 1.25x the plain version's of its own mode in "high" and "bf16" (the
    same bf16 operands); and it is within 1e-4 ("highest") or 1e-3 of the
    scale of the plain version of its mode."""
    dev = _cuda()
    cfg = LogMelConfig(num_mel_bins=n_mel, matmul_precision=mode)
    wav = torch.from_numpy(_speech_batch(B, S, seed=B) * (1e-4 if quiet else 1.0)).to(dev)
    fe = K3.MelFrontEnd(cfg, device=dev)
    n_frames = int(cfg.num_frames(S))
    args = (n_frames, fe.dft, fe.mel, cfg.hop_length, cfg.mel_floor, mode)
    _build.reset_launch_counts()
    got = K3.log_mel(wav, *args)
    label = "asr_log_mel" if mode == "highest" else f"asr_log_mel_{mode}"
    assert dict(_build.LAUNCHES) == {label: 1} and got.shape == (B, n_frames, n_mel)
    plain = K3.log_mel_plain(wav, *args)
    dft64, _ = K3.folded_bases(cfg)
    exact = K3.log_mel_plain(wav.double(), n_frames, torch.from_numpy(dft64).to(dev).double(), fe.mel.double(),
                             cfg.hop_length, cfg.mel_floor)
    err_kernel = float((got.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    assert err_kernel <= (2.0 if mode == "highest" else 1.25) * err_plain, (err_kernel, err_plain)
    _close(got, plain, 1e-4 if mode == "highest" else 1e-3)


@pytest.mark.parametrize("T", [40, 250, 256, 504])
@pytest.mark.parametrize("width", ["32", "44->64", "64, q_rot 512"])
def test_pos_query_against_plain(narrow, width, T):
    """The positional query on wgmma at head width 32 (8 heads, q_rot 256: the
    flagship's widths, seeded weights), 44 padded to 64 (the 176-wide fold's
    own weights and tables, q_rot 176 -> 192) and 64 with q_rot 512 (the
    512-wide config's widths: two boxes of weight rows), M = 3T - 24 rows (no
    multiple of the 64-row tile; a tile crosses utterance boundaries), q_v a
    column view of a wider buffer (row stride > H * dh): within 2^-7 of the
    scale, the pad columns of q_rot exact zeros."""
    dev = _cuda()
    g = torch.Generator().manual_seed(T)
    M = 3 * T - 24
    if width != "44->64":
        H, hw, D, pad = (8, 32, 256, 0) if width == "32" else (8, 64, 512, 0)
        wp = (torch.randn(H, D, hw, generator=g) * 0.2).bfloat16().to(dev)
        tables = K1.relpos_kernel_tables(T, D, device=dev)
    else:
        _, fm = narrow
        wp, hw = fm.layers[0]["wp"], 64
        H, D, pad = wp.shape[0], wp.shape[1], (K1.rot_width(176) - 176) // 2
        tables = fm.tables(T)
    buf = torch.randn(M, H * hw + 24, generator=g).bfloat16().to(dev)
    if width == "44->64":
        buf.view(M, -1)[:, :H * hw].view(M, H, hw)[..., 44:] = 0.0  # the fold's zero pad columns of q_v
    q_v = buf[:, :H * hw]
    assert q_v.stride(0) == H * hw + 24
    _build.reset_launch_counts()
    q_rot = K1.pos_query(q_v, wp, tables["rot_cos"], tables["rot_sin"], T)
    assert _build.LAUNCHES["asr_pos_query"] == 1 and q_rot.shape == (M, H, D)
    _close(q_rot, K1.pos_query_plain(q_v, wp, tables["rot_cos"], tables["rot_sin"], T), 2 ** -7)
    if pad:
        half = D // 2
        assert not q_rot[..., half - pad:half].any() and not q_rot[..., D - pad:].any()


def test_layer_pieces_and_layer(fused):
    dev = _cuda()
    _, fm = fused
    w, B, T, t_valid = fm.layers[0], 3, 40, 37
    D, H = CFG.hidden_size, CFG.num_attention_heads
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, T, D, generator=g).bfloat16().to(dev)
    lens = torch.tensor([37, 20, 0], dtype=torch.int32, device=dev)
    tables = fm.tables(T)
    xf = x.view(B * T, D)
    _close(K1.layer_norm(xf, w["ff1_ln_g"], w["ff1_ln_b"], 1e-5),
           K1.layer_norm_plain(xf, w["ff1_ln_g"], w["ff1_ln_b"], 1e-5), 2 ** -7)
    _close(K1.gemm(xf, w["ff1_wi"], w["ff1_bi"], act="gelu"),
           K1.gemm_plain(xf, w["ff1_wi"], w["ff1_bi"], act="gelu"), 2 ** -6)
    qkv, q_v = K1.gemm(xf, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])
    _close(qkv, K1.gemm_plain(xf, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])[0], 2 ** -6)
    q_rot = K1.pos_query(q_v, w["wp"], tables["rot_cos"], tables["rot_sin"], T)
    _close(q_rot, K1.pos_query_plain(q_v, w["wp"], tables["rot_cos"], tables["rot_sin"], T), 2 ** -7)
    hv = lambda i: qkv[:, i * D:(i + 1) * D].view(B, T, H, D // H)
    qr = q_rot.view(B, T, H, D)
    _close(K1.rel_attention(hv(0), hv(1), hv(2), qr, tables["k_std"], lens),
           K1.rel_attention_plain(hv(0), hv(1), hv(2), qr, tables["k_std"], lens), 2 ** -6)
    l = K1.gemm(xf, w["cg_w1"], w["cg_b1"], act="gelu")
    args = (w["csgu_ln_g"], w["csgu_ln_b"], w["csgu_dw"], w["csgu_dw_b"], B, T, t_valid,
            "identity", 1e-5)
    _close(K1.csgu(l, *args), K1.csgu_plain(l, *args), 2 ** -7)
    merged = torch.cat([xf, xf], dim=1).contiguous()
    margs = (w["merge_dw"], w["merge_dw_b"], B, T, t_valid)
    _close(K1.merge_conv(merged, *margs), K1.merge_conv_plain(merged, *margs), 2 ** -7)
    _close(K1.ebranchformer_layer(x, lens, w, CFG, t_valid, tables),
           K1.ebranchformer_layer_plain(x, lens, w, CFG, t_valid, tables), 0.05)


@pytest.mark.parametrize("B,T2", [(2, 32), (3, 40), (1, 8), (2, 24)])  # conv2 tiles hold 6 output frames: ragged, and whole at 24
def test_subsample(fused, B, T2):
    dev = _cuda()
    _, fm = fused
    feats = torch.randn(B, 101, 80, generator=torch.Generator().manual_seed(2)).bfloat16().to(dev)
    w = fm.subsample
    y1 = K2.conv1(feats, w["w1"], w["b1"])
    _close(y1, K2.conv1_plain(feats, w["w1"], w["b1"]), 2 ** -7)
    _build.reset_launch_counts()
    y2 = K2.conv2(y1, w["w2"], w["b2"], T2)
    assert _build.LAUNCHES["asr_conv2"] == 1 and y2.shape == (B * T2 * 20, 256)
    _close(y2, K2.conv2_plain(y1, w["w2"], w["b2"], T2), 2 ** -6)
    _close(K2.conv_subsample(feats, w, CFG, T2), K2.conv_subsample_plain(feats, w, CFG, T2), 0.05)


# ---- conv1 (csrc/subsample.cu) and the utterance CMVN (csrc/mel.cu::cmvn_kernel)
# where their designs can break: conv1's persistent warps at frame counts that
# leave warps idle or take two frames, the time padding at odd and even T_in,
# the GELU table's edges; the CMVN cluster's slices at frame counts that are no
# multiple of them, lengths at 0, 1, 2, n_frames - 1 and n_frames, frames that
# do not fit a block's shared memory at once, all four normalisation modes.


def _close_nan(got, ref, rel):
    """``_close`` on the finite values; NaNs and infinities must sit in the
    same places on both sides, the infinities with the same sign."""
    g, r = got.float(), ref.float()
    assert torch.equal(torch.isnan(g), torch.isnan(r))
    inf = torch.isinf(r)
    assert torch.equal(torch.isinf(g), inf) and torch.equal(g[inf], r[inf])
    finite = torch.isfinite(r)
    _close(torch.where(finite, g, 0.0), torch.where(finite, r, 0.0), rel)


@pytest.mark.parametrize("B", [1, 3, 33])
@pytest.mark.parametrize("T_in", [998, 997, 1, 2, 3])
def test_conv1_against_plain(fused, B, T_in):
    dev = _cuda()
    _, fm = fused
    w = fm.subsample
    feats = torch.randn(B, T_in, 80, generator=torch.Generator().manual_seed(B * T_in)).bfloat16().to(dev)
    _build.reset_launch_counts()
    got = K2.conv1(feats, w["w1"], w["b1"])
    assert _build.LAUNCHES["asr_conv1"] == 1 and got.shape == (B, (T_in - 1) // 2 + 1, 40, 256)
    _close(got, K2.conv1_plain(feats, w["w1"], w["b1"]), 2 ** -7)


@pytest.mark.parametrize("bias", ["zero", "seeded"])
def test_conv1_gelu_on_every_bf16_value(bias):
    """With the centre tap 1 and the others 0, conv1's output at (t1, f1) in
    channel c is GELU(bf16(x + b1[c])) of the input x at (2 t1, 2 f1): all
    65,536 bf16 values (zeros, subnormals, infinities and NaNs among them) sit
    at those places, zeros everywhere else. With a zero bias every channel is
    the GELU of every bf16 value; seeded biases of magnitudes from 2^-30 to
    2^6, both signs, hold the bias add's rounding against the plain version's
    on every input too. The kernel's output equals the plain version's
    expression (``act_plain("gelu")`` of the bf16 sum, rounded to bf16: what
    ``conv1_plain`` applies) exactly, NaNs in place."""
    dev = _cuda()
    T1, F1 = 1639, 40
    values = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    grid = torch.zeros(T1 * F1, dtype=torch.bfloat16)
    grid[:65536] = values
    feats = torch.zeros(1, 2 * T1 - 1, 2 * F1, dtype=torch.bfloat16)
    feats[0, 0::2, 0::2] = grid.view(T1, F1)
    w1 = torch.zeros(9, 256, dtype=torch.bfloat16, device=dev)
    w1[4] = 1.0
    b1 = torch.zeros(256)
    if bias == "seeded":
        g = torch.Generator().manual_seed(7)
        b1 = torch.randn(256, generator=g).sign() * 2.0 ** torch.randint(-30, 7, (256,), generator=g)
        b1 = (b1 * (1.0 + torch.rand(256, generator=g))).bfloat16().float()
    b1 = b1.to(dev)
    got = K2.conv1(feats.to(dev), w1, b1).float()
    x = grid.float().to(dev).view(1, T1, F1, 1)
    ref = K1.act_plain("gelu", (x + b1).bfloat16().float()).bfloat16().float()
    nan = torch.isnan(ref)
    assert int(nan.sum()) > 0 and torch.equal(torch.isnan(got), nan)
    assert torch.equal(torch.where(nan, 0.0, got), torch.where(nan, 0.0, ref))


@pytest.mark.parametrize("norm_means,norm_vars", [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("n_frames", [998, 13, 4801])
@pytest.mark.parametrize("n_mel", [23, 80, 128])
def test_cmvn_lengths_and_modes(n_mel, n_frames, norm_means, norm_vars):
    """The CMVN kernel at 23 (column groups of one bin, a value a thread),
    80 and 128 bins (4-bin groups, 16-byte pieces), in each normalisation
    mode, at lengths 0, 1, 2, all but one, all and half, and at 4,801 frames
    (past what a block holds at once): within 2^-7 of the plain version's
    scale, non-finite values where it has them, zeros past each length."""
    dev = _cuda()
    lens = [0, 1, 2, n_frames - 1, n_frames, n_frames // 2 + 3]
    g = torch.Generator().manual_seed(n_frames)
    lm = (torch.randn(len(lens), n_frames, n_mel, generator=g) * 3.0 - 4.0).to(dev)
    n = torch.tensor(lens, dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    got = K3.cmvn(lm, n, norm_means, norm_vars)
    assert _build.LAUNCHES["asr_cmvn"] == 1 and got.dtype == torch.bfloat16 and got.shape == lm.shape
    _close_nan(got, K3.cmvn_plain(lm, n, norm_means, norm_vars), 2 ** -7)
    for i, length in enumerate(lens):
        assert not got[i, max(length, 0):].float().any()


@pytest.mark.parametrize("B", [1, 128])
def test_conv1_and_cmvn_at_the_frames_of_10_s(fused, B):
    """B = 128 x 998 frames (a B=128 x 10 s request) and one utterance: a
    cluster then holds one utterance's work."""
    dev = _cuda()
    _, fm = fused
    w = fm.subsample
    g = torch.Generator().manual_seed(B)
    lm = (torch.randn(B, 998, 80, generator=g) * 2.0 - 3.0).to(dev)
    n = torch.tensor([998 - (7 * i) % 200 for i in range(B)], dtype=torch.int32, device=dev)
    feats = K3.cmvn(lm, n)
    _close_nan(feats, K3.cmvn_plain(lm, n), 2 ** -7)
    _close(K2.conv1(feats, w["w1"], w["b1"]), K2.conv1_plain(feats, w["w1"], w["b1"]), 2 ** -7)


def test_conv1_and_cmvn_refuse_what_they_do_not_take():
    dev = _cuda()
    with pytest.raises(RuntimeError):  # conv1 holds C == 256 channels in a warp
        K2.conv1(torch.zeros(1, 9, 80, dtype=torch.bfloat16, device=dev),
                 torch.zeros(9, 64, dtype=torch.bfloat16, device=dev), torch.zeros(64, device=dev))
    with pytest.raises(ValueError, match="at most MEL_MAX_BINS = 128"):  # cmvn takes any count up to the limit
        K3.cmvn(torch.zeros(2, 9, 129, device=dev), torch.ones(2, dtype=torch.int32, device=dev))


def test_ctc_infer_launches_kernels_and_matches_plain(fused):
    dev = _cuda()
    _, fm = fused
    feats = torch.randn(3, 150, 80, generator=torch.Generator().manual_seed(3)).to(dev)
    lens = torch.tensor([150, 96, 41], dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    got = ctc_infer(fm, feats, lens)
    assert _build.LAUNCHES["asr_rel_attention"] == CFG.num_hidden_layers
    assert _build.LAUNCHES["asr_conv1"] == 1
    ref = ctc_infer(fm, feats, lens, plain=True)
    assert torch.equal(got.logit_lengths, ref.logit_lengths)
    _close(got.logits, ref.logits, 0.05)


# ---- the depthwise convs (csrc/dwconv.cu, dwconv_csgu.cu): both tilings
# (M = 56 and 2,048 rows take the 16-row tiles, 32,768 the 64-row tiles),
# every compiled kernel size (K = 3 runs on the 7-tap kernel), t_valid at 1,
# at T and off the tiles' edges.


def _dw_inputs(dev, mode, B, T, C, K, seed, lead=0):
    """(x, ln_g, ln_b, w, bias); x is a row view ``lead`` columns into a wider buffer."""
    g = torch.Generator().manual_seed(seed)
    width = 2 * C if mode == 0 else C
    x = torch.randn(B * T, width + 2 * lead, generator=g).bfloat16().to(dev)[:, lead:lead + width]
    w = (torch.randn(K, C, generator=g) * K ** -0.5).bfloat16().to(dev)
    bias, ln_b = (torch.randn(C, generator=g) * 0.1).to(dev), (torch.randn(C, generator=g) * 0.1).to(dev)
    ln_g = (1.0 + 0.1 * torch.randn(C, generator=g)).to(dev)
    return x, ln_g, ln_b, w, bias


def _dw_both(mode, x, ln_g, ln_b, w, bias, B, T, t_valid, act="identity", out=None):
    """(kernel output, plain output) of one form of the conv."""
    label = ("dwconv_csgu", "dwconv_merge")[mode]
    if mode == 0:
        got = K1._dwconv(0, x, ln_g, ln_b, w, bias, B, T, t_valid, act, 1e-5, label, out=out)
        return got, K1.csgu_plain(x, ln_g, ln_b, w, bias, B, T, t_valid, act, 1e-5)
    got = K1._dwconv(1, x, None, None, w, bias, B, T, t_valid, "identity", 0.0, label, out=out)
    return got, K1.merge_conv_plain(x, w, bias, B, T, t_valid)


@pytest.mark.parametrize("t_valid", ["ragged", 1, "T"])
@pytest.mark.parametrize("K", [3, 31, 33])
@pytest.mark.parametrize("B,T", [(1, 56), (8, 256), (128, 256)])
@pytest.mark.parametrize("mode", [0, 1])
def test_dwconv_against_plain(mode, B, T, K, t_valid):
    dev = _cuda()
    tv = {"ragged": T - 5, "T": T}.get(t_valid, t_valid)
    args = _dw_inputs(dev, mode, B, T, 512, K, seed=B + T + K)
    _build.reset_launch_counts()
    got, ref = _dw_both(mode, *args, B, T, tv)
    assert sum(_build.LAUNCHES.values()) == 1
    _close(got, ref, 2 ** -7)


@pytest.mark.parametrize("act", sorted(K1.ACT_CODES))
def test_dwconv_csgu_activations(act):
    dev = _cuda()
    args = _dw_inputs(dev, 0, 3, 70, 128, 7, seed=4)
    _close(*_dw_both(0, *args, 3, 70, 61, act=act), 2 ** -7)


@pytest.mark.parametrize("C", [64, 128, 256, 384, 768])
@pytest.mark.parametrize("mode", [0, 1])
def test_dwconv_channel_counts(mode, C):
    """Channel counts of 64 to 768 (merge also 1,000: one slice of all C)."""
    dev = _cuda()
    for B, T in ((3, 70), (128, 200)):
        args = _dw_inputs(dev, mode, B, T, C, 31, seed=C + T)
        _close(*_dw_both(mode, *args, B, T, T - 3), 2 ** -7)
    if mode == 1 and C == 768:
        args = _dw_inputs(dev, 1, 3, 70, 1000, 33, seed=1000)
        _close(*_dw_both(1, *args, 3, 70, 67), 2 ** -7)


@pytest.mark.parametrize("B,T", [(8, 256), (128, 256)])
def test_dwconv_csgu_on_a_strided_l(B, T):
    """``l`` as a row view with 64 columns on each side, as a column slice of a wider buffer is."""
    dev = _cuda()
    args = _dw_inputs(dev, 0, B, T, 512, 31, seed=9, lead=64)
    assert not args[0].is_contiguous()
    got = K1.csgu(*args, B, T, T - 5, "identity", 1e-5)
    _close(got, K1.csgu_plain(*args, B, T, T - 5, "identity", 1e-5), 2 ** -7)
    contiguous = K1.csgu(args[0].contiguous(), *args[1:], B, T, T - 5, "identity", 1e-5)
    assert torch.equal(got, contiguous)


@pytest.mark.parametrize("T", [70, 256])
@pytest.mark.parametrize("B", [3, 128])
@pytest.mark.parametrize("mode", [0, 1])
def test_dwconv_writes_no_row_past_T(mode, B, T):
    """Output into the first B*T rows of a larger buffer: the rows after them
    keep their value, and every utterance's rows are its own (T is no multiple
    of either tile at 70)."""
    dev = _cuda()
    args = _dw_inputs(dev, mode, B, T, 512, 31, seed=B * T)
    guard = torch.full((B * T + 80, 512), 7.0, dtype=torch.bfloat16, device=dev)
    got, ref = _dw_both(mode, *args, B, T, T - 9, out=guard[:B * T])
    torch.cuda.synchronize()
    assert bool((guard[B * T:] == 7.0).all())
    _close(got, ref, 2 ** -7)


def test_dwconv_refusals_on_the_card():
    dev = _cuda()
    x, ln_g, ln_b, w, bias = _dw_inputs(dev, 0, 2, 16, 64, 7, seed=0)
    with pytest.raises(ValueError):  # even K
        K1.csgu(x, ln_g, ln_b, w[:6].contiguous(), bias, 2, 16, 16, "identity", 1e-5)
    with pytest.raises(ValueError):  # K > 33
        K1.csgu(x, ln_g, ln_b, w.repeat(5, 1)[:35].contiguous(), bias, 2, 16, 16, "identity", 1e-5)
    with pytest.raises(ValueError):  # C % 8
        K1.merge_conv(x[:, :60].contiguous(), w[:, :60].contiguous(), bias[:60].contiguous(), 2, 16, 16)
    with pytest.raises(ValueError):  # fp32 rows
        K1.merge_conv(x[:, :64].float(), w[:, :64].contiguous(), bias, 2, 16, 16)
    with pytest.raises(ValueError):  # a row stride that is no multiple of 8
        K1.csgu(torch.zeros(32, 132, dtype=torch.bfloat16, device=dev)[:, :128], ln_g, ln_b, w, bias,
                2, 16, 16, "identity", 1e-5)
    with pytest.raises(ValueError):  # bias on the CPU
        K1.merge_conv(x[:, :64].contiguous(), w, bias.cpu(), 2, 16, 16)


def test_pipeline_logs_why_the_fused_path_is_refused(tmp_path, caplog):
    """A config outside the fused path (head size 128) serves through the
    plain model on the card, and the pipeline says why in one line."""
    import logging

    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from huggingface_asr_tpu_torch.training.model_factory import save_params

    _cuda()
    cfg = EBranchformerConfig(hidden_size=128, num_hidden_layers=1, num_attention_heads=1, intermediate_size=256,
                              csgu_kernel_size=7, merge_conv_kernel=7, vocab_size=20)
    save_params(init_random_(EBranchformerForCTC(cfg).eval(), torch.Generator().manual_seed(0)), str(tmp_path))

    class Ids:
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(map(str, ids))

    with caplog.at_level(logging.WARNING, logger="huggingface_asr_tpu_torch.serving.pipeline"):
        pipe = ASRPipeline(str(tmp_path), model_type="ctc", device="cuda", tokenizer=Ids())
    assert not pipe._use_fused
    lines = [r.getMessage() for r in caplog.records if r.name == "huggingface_asr_tpu_torch.serving.pipeline"]
    assert lines == ["serving through the plain model, not the fused kernels: head size 128 (the attention kernels "
                     "take head sizes of at most 64)"]
    assert isinstance(pipe(np.zeros(16000, np.float32)), str)


def _attention_inputs(dev, dtype, B, T, H, D, seed):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dtype).to(dev)  # noqa: E731
    return mk(B, T, H, 32), mk(B, T, H, D), mk(B, T, H, 32), mk(B, T, H, 32), mk(T, D), mk(B, T, H, 32)


# Tolerances of the attention kernels against their plain versions. fp32: the
# kernel's FMA loops and the plain matmuls sum in another order (1e-4 of the
# scale). bf16: both round P, Pd and dS to bf16 at the same points, so they
# differ where an fp32 value lands on the other side of a rounding boundary:
# 2^-6 of each tensor's scale. The keep-mask is the same function on both
# sides, so dropout changes neither tolerance.
ATT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T,lens", [(70, [70, 33, 0]), (129, [129, 64, 1]), (333, [1, 333, 0])])
def test_train_attention_forward_and_backward(dtype, rate, T, lens):
    dev = _cuda()
    B, H, D = 3, 4, 128
    q_u, q_rot, k, v, k_std, cot = _attention_inputs(dev, dtype, B, T, H, D, seed=T)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q_u, q_rot, k, v)]
        out = fn(*leaves, k_std, lengths, 1234, rate)
        out.backward(cot)
        return [out.detach()] + [t.grad for t in leaves]

    _build.reset_launch_counts()
    got = run(rel_attention_train)
    assert _build.LAUNCHES["asr_rel_attention_train_fwd"] == 1
    assert _build.LAUNCHES["asr_rel_attention_train_bwd"] == 1
    ref = run(rel_attention_train_plain)
    assert sum(_build.LAUNCHES.values()) == 2
    for name, g, r in zip(("out", "dq_u", "dq_rot", "dk", "dv"), got, ref):
        assert g.dtype == dtype and g.shape == r.shape, name
        _close(g, r, ATT_TOL[dtype])


BWD_LENGTHS = {70: [70, 1, 0], 250: [250, 1, 0, 167], 333: [333, 1, 0, 200], 500: [500, 437, 0, 1]}
# bf16 (the wgmma kernels) at every width and length; fp32 (FMA loops, slow) at the smaller ones
BWD_CASES = [(torch.bfloat16, H, D, T) for H, D in ((2, 64), (4, 128), (8, 256)) for T in BWD_LENGTHS] \
    + [(torch.float32, H, D, T) for H, D in ((2, 64), (4, 128)) for T in (70, 250, 333)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype,H,D,T", BWD_CASES)
def test_train_attention_backward_widths_and_lengths(dtype, H, D, T, rate):
    """The four gradients at every width the kernels take, at lengths with 0
    and 1, past one key tile and past one block of rows. bf16 runs the wgmma
    kernels of ``rel_attention_train_bwd.cu``, fp32 the FMA kernels."""
    dev = _cuda()
    lens = BWD_LENGTHS[T]
    B = len(lens)
    q_u, q_rot, k, v, k_std, cot = _attention_inputs(dev, dtype, B, T, H, D, seed=T + D)
    q_rot = q_rot * 0.25
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q_u, q_rot, k, v)]
        return torch.autograd.grad(fn(*leaves, k_std, lengths, 99, rate), leaves, cot)

    _build.reset_launch_counts()
    got = grads(rel_attention_train)
    assert _build.LAUNCHES["asr_rel_attention_train_bwd"] == 1
    for name, g, r in zip(("dq_u", "dq_rot", "dk", "dv"), got, grads(rel_attention_train_plain)):
        assert g.dtype == dtype and g.shape == r.shape, name
        _close(g, r, ATT_TOL[dtype])
    # keys past every row's visited keys get exact zeros
    if T == 250:
        assert not bool(got[2][1, 1:].any()) and not bool(got[3][1, 1:].any())


def _layer_gemm_calls(dev, M, seed, D=256, I=1024, subsampler=True):
    """Every GEMM call of a layer of width D (FF I wide, cgMLP I -> I / 2;
    the flagship's D=256, I=1024 by default) and, with ``subsampler``, of the
    flagship's subsampler (5120 -> 256 -> 256), as (name, a, w, bias,
    kwargs); wo and cg_w2 write the two halves of a (M + 8, 2D) buffer."""
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).bfloat16().to(dev)  # noqa: E731
    wt = lambda k, n: (torch.randn(k, n, generator=g) * k ** -0.5).bfloat16().to(dev)  # noqa: E731
    bias = lambda n: torch.randn(n, generator=g).bfloat16().float().to(dev)  # noqa: E731
    C = I // 2
    x = mk(M, D)
    merged = torch.full((M + 8, 2 * D), 7.0, dtype=torch.bfloat16, device=dev)
    calls = [
        ("ff_in gelu", x, wt(D, I), bias(I), dict(act="gelu")),
        ("ff_in swish", x, wt(D, I), bias(I), dict(act="swish")),
        ("ff_out", mk(M, I), wt(I, D), bias(D), dict(residual=x, alpha=0.5)),
        ("qkv", x, wt(D, 3 * D), bias(3 * D), dict(bias2=bias(D))),
        ("wo", x, wt(D, D), bias(D), dict(out=merged[:M, :D])),
        ("cg_w1", x, wt(D, 2 * C), bias(2 * C), dict(act="gelu")),
        ("cg_w2", mk(M, C), wt(C, D), bias(D), dict(out=merged[:M, D:])),
        ("merge", mk(M, 4 * D)[:, D:3 * D], wt(2 * D, D), bias(D), dict(residual=x, alpha=1.0)),
    ]
    if subsampler:
        calls += [("out-dense", mk(M, 5120), wt(5120, D), bias(D), dict(round_first=True)),
                  ("proj", x, wt(D, D), bias(D), dict(round_first=True))]
    return merged, calls


def _check_layer_gemms(M, D, I, subsampler):
    """Each call of ``_layer_gemm_calls`` against ``gemm_plain`` (both outputs
    of the dual one); rows past M and the other half of a sliced output stay
    as they were; one launch a call."""
    dev = _cuda()
    merged, calls = _layer_gemm_calls(dev, M, M + D, D, I, subsampler)
    _build.reset_launch_counts()
    for name, a, w, bias, kw in calls:
        got = K1.gemm(a, w, bias, **kw)
        ref_kw = {k: v for k, v in kw.items() if k != "out"}
        ref = K1.gemm_plain(a, w, bias, **ref_kw)
        if "bias2" in kw:
            _close(got[1], ref[1], 2 ** -6)
            got, ref = got[0], ref[0]
        _close(got, ref, 2 ** -6)
        if name == "wo":
            assert bool((merged[:M, D:] == 7.0).all()) and bool((merged[M:] == 7.0).all()), name
        if name == "cg_w2":
            assert bool((merged[M:] == 7.0).all()), name
            _close(merged[:M, :D], K1.gemm_plain(*calls[4][1:4]), 2 ** -6)  # wo's half is still wo's
    assert _build.LAUNCHES["asr_gemm_bf16"] == len(calls)


@pytest.mark.parametrize("M", [56, 2048, 8200, 32768])
def test_gemm_at_the_flagship_call_shapes(M):
    """Both kernels, a ragged M in each (56 in the small one, 8,200 in the
    large one), every epilogue; rows past M and the other half of a sliced
    output stay untouched."""
    _check_layer_gemms(M, 256, 1024, subsampler=True)


@pytest.mark.parametrize("M", [56, 2048, 8200, 32768])
def test_gemm_at_the_512_wide_call_shapes(M):
    """The 512-wide config's layer GEMMs (D=512, I=2048, cgMLP 2048 -> 1024:
    N and K of 512, 1,024, 1,536 and 2,048), every epilogue, in both kernels,
    as at the flagship's widths."""
    _check_layer_gemms(M, 512, 2048, subsampler=False)


@pytest.mark.parametrize("M", [56, 2048, 32768])
@pytest.mark.parametrize("D", [176, 256, 512])
def test_layernorm_at_the_configs_widths(D, M):
    """The LayerNorm at the shipped configs' widths (176, 256, 512): ragged
    and whole blocks of rows."""
    dev = _cuda()
    g = torch.Generator().manual_seed(D + M)
    x = (torch.randn(M, D, generator=g) * 3.0 + 0.5).bfloat16().to(dev)
    gamma, beta = (1.0 + 0.1 * torch.randn(D, generator=g)).to(dev), (0.1 * torch.randn(D, generator=g)).to(dev)
    _build.reset_launch_counts()
    got = K1.layer_norm(x, gamma, beta, 1e-5)
    assert _build.LAUNCHES["asr_layernorm_bf16"] == 1
    _close(got, K1.layer_norm_plain(x, gamma, beta, 1e-5), 2 ** -7)


@pytest.mark.parametrize("D", [64, 128, 192])
def test_gemm_at_narrow_widths(D):
    """N = 3D that is no multiple of the large tile's 128 columns, a second
    output narrower than a tile, and a K that is no multiple of a 64-deep step."""
    dev = _cuda()
    g = torch.Generator().manual_seed(D)
    mk = lambda *s: torch.randn(*s, generator=g).bfloat16().to(dev)  # noqa: E731
    for M in (40, 9000):
        a, w, bias, bias2 = mk(M, D), mk(D, 3 * D) * D ** -0.5, mk(3 * D).float(), mk(D).float()
        got, ref = K1.gemm(a, w, bias, bias2=bias2), K1.gemm_plain(a, w, bias, bias2=bias2)
        _close(got[0], ref[0], 2 ** -6)
        _close(got[1], ref[1], 2 ** -6)
        a96, w96 = mk(M, 96), mk(96, D) * 96 ** -0.5  # K = 96: the second k-step is half out of range
        _close(K1.gemm(a96, w96), K1.gemm_plain(a96, w96), 2 ** -6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,lens", [(70, [70, 33, 0]), (129, [129, 64, 1])])
def test_shift_attention(dtype, T, lens):
    dev = _cuda()
    B, H = 3, 4
    q_u, _, k, v, _, q_v = _attention_inputs(dev, dtype, B, T, H, 16, seed=T + 1)
    pos = torch.randn(2 * T - 1, H, 32, generator=torch.Generator().manual_seed(9)).to(dtype).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    got = rel_attention(q_u, q_v, k, v, pos, lengths)
    assert _build.LAUNCHES["asr_rel_attention_shift"] == 1
    _close(got, rel_attention_plain_shift(q_u, q_v, k, v, pos, lengths), ATT_TOL[dtype])


@pytest.mark.parametrize("T,lens", [(333, [333, 1, 0, 200]), (500, [500, 437, 0, 1])])
def test_shift_attention_bf16_past_one_block(T, lens):
    """The bf16 kernel over several query blocks and key tiles at the flagship
    head count: ragged last tiles, rows of length 1 and 0."""
    dev = _cuda()
    B, H = 4, 8
    q_u, _, k, v, _, q_v = _attention_inputs(dev, torch.bfloat16, B, T, H, 16, seed=T + 2)
    pos = torch.randn(2 * T - 1, H, 32, generator=torch.Generator().manual_seed(10)).bfloat16().to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    got = rel_attention(q_u, q_v, k, v, pos, lengths)
    assert _build.LAUNCHES["asr_rel_attention_shift"] == 1
    _close(got, rel_attention_plain_shift(q_u, q_v, k, v, pos, lengths), ATT_TOL[torch.bfloat16])


@pytest.mark.parametrize("DH", [32, 64])
@pytest.mark.parametrize("T,lens", [(70, [70, 1, 0, 33]), (333, [333, 1, 0, 200]), (1000, [1000, 0, 1, 677])])
def test_shift_attention_fp32_walk(DH, T, lens):
    """The fp32 kernel (one walk of the keys, a band chunk a key tile) over
    several query blocks and key tiles: ragged last tiles, rows of length 0,
    1, a ragged length and T. At T=1000 the plain version gathers a (T, T, H,
    dh) table, so H is 2 there. One launch a call."""
    dev = _cuda()
    B, H = len(lens), 4 if T < 1000 else 2
    g = torch.Generator().manual_seed(T + DH)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
    args = (mk(B, T, H, DH), mk(B, T, H, DH), mk(B, T, H, DH), mk(B, T, H, DH), mk(2 * T - 1, H, DH),
            torch.tensor(lens, dtype=torch.int32, device=dev))
    _build.reset_launch_counts()
    got = rel_attention(*args)
    assert dict(_build.LAUNCHES) == {"asr_rel_attention_shift": 1} and got.shape == (B, T, H, DH)
    _close(got, rel_attention_plain_shift(*args), ATT_TOL[torch.float32])


@pytest.mark.parametrize("B,T,H,D,lens", [(2, 64, 4, 128, [64, 0]), (3, 192, 4, 128, [187, 1, 0]),
                                          (2, 752, 8, 256, [752, 0]), (3, 752, 8, 256, [700, 1, 440])])
def test_layer_rel_attention_on_strided_views(B, T, H, D, lens):
    """The fused layer's attention kernel on column views of one (B*T, 3 * H * 32)
    buffer: fewer rows than one block, key loops past one tile, a ragged last
    tile (752 = 11.75 tiles), rows of length 0 and 1."""
    dev = _cuda()
    g = torch.Generator().manual_seed(T + B)
    mk = lambda *s: torch.randn(*s, generator=g).bfloat16().to(dev)  # noqa: E731
    qkv, q_rot, k_std = mk(B * T, 3 * H * 32), mk(B, T, H, D) * 0.25, mk(T, D)
    q_u, k, v = (qkv[:, i * H * 32:(i + 1) * H * 32].view(B, T, H, 32) for i in range(3))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    got = K1.rel_attention(q_u, k, v, q_rot, k_std, lengths)
    assert _build.LAUNCHES["asr_rel_attention"] == 1 and got.shape == (B, T, H, 32)
    _close(got, K1.rel_attention_plain(q_u, k, v, q_rot, k_std, lengths), 2 ** -6)


@pytest.mark.parametrize("D", [48, 96, 576])
def test_layer_rel_attention_raises_on_widths_it_does_not_take(D):
    """D must be whole 64-column chunks and fit a block's shared memory. A
    config whose width rounds up to at most 512 takes the fused path on the
    fold's padded operands (96 -> 128); one past 512 (576) is kept off it."""
    from huggingface_asr_tpu_torch.models.fast_infer import fused_encoder_ok

    dev = _cuda()
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device=dev)  # noqa: E731
    lengths = torch.tensor([8], dtype=torch.int32, device=dev)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        K1.rel_attention(z(1, 8, 2, 32), z(1, 8, 2, 32), z(1, 8, 2, 32), z(1, 8, 2, D), z(8, D), lengths)
    assert dict(_build.LAUNCHES) == before
    if D % 32 == 0:
        cfg = dataclasses.replace(CFG, hidden_size=D, num_attention_heads=D // 32, conv_dim=(256, 256))
        assert cfg.head_size == 32 and fused_encoder_ok(cfg, torch.bfloat16) == (K1.rot_width(D) <= K1.ROT_MAX)
        assert fused_encoder_ok(dataclasses.replace(cfg, hidden_size=128, num_attention_heads=4), torch.bfloat16)


@pytest.mark.parametrize("impl,heads,launched", [("auto", 4, True), ("pallas", 4, True), ("xla", 4, False),
                                                 ("auto", 1, None), ("pallas", 1, None)])
def test_model_attention_dispatch_on_the_card(impl, heads, launched):
    """Training forward on CUDA tensors: "auto" and "pallas" take the kernel,
    and raise on a model the kernel does not take (head size 128 here); only
    "xla" runs the plain attention."""
    from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng

    dev = _cuda()
    cfg = dataclasses.replace(CFG, attention_impl=impl, num_attention_heads=heads, num_hidden_layers=1)
    model = init_random_(EBranchformerForCTC(cfg), torch.Generator().manual_seed(0)).to(dev)
    feats = torch.randn(2, 64, 80, generator=torch.Generator().manual_seed(1)).to(dev)
    lens = torch.tensor([64, 40], dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    if launched is None:
        with pytest.raises(ValueError):
            model(feats, lens, rng=DropoutRng(0, dev))
        return
    out = model(feats, lens, rng=DropoutRng(0, dev))
    assert bool(torch.isfinite(out.logits).all())
    assert (_build.LAUNCHES["asr_rel_attention_train_fwd"] == 1) == launched


# ---- q_rot past 256 columns (the k_std chunk ring) and the CSGU conv past 768
# channels (128-channel slices behind a row-statistics pass): the 512-wide
# config's shapes (head 64, q_rot 512, CSGU 1,024 channels), other widths of
# the same paths, and the widths of the paths before them at 256 / 768.


@pytest.mark.parametrize("B,T,H,DH,D,lens", [(2, 250, 8, 64, 512, [250, 0]), (3, 752, 8, 64, 512, [700, 1, 440]),
                                             (8, 256, 8, 64, 512, [250, 250, 200, 1, 0, 64, 65, 128]),
                                             (2, 192, 4, 32, 320, [187, 0]), (2, 250, 8, 64, 256, [250, 3]),
                                             (2, 250, 8, 32, 256, [250, 3])])
def test_layer_rel_attention_past_256_columns(B, T, H, DH, D, lens):
    """The fused layer's attention at the 512-wide config's widths (and 320
    at head width 32) on column views of one (B*T, 3 * H * DH) buffer, key
    loops past one tile, lengths 0 and 1; 256 keeps the stage path."""
    dev = _cuda()
    g = torch.Generator().manual_seed(T + D)
    mk = lambda *s: torch.randn(*s, generator=g).bfloat16().to(dev)  # noqa: E731
    qkv, q_rot, k_std = mk(B * T, 3 * H * DH), mk(B, T, H, D) * 0.25, mk(T, D)
    q_u, k, v = (qkv[:, i * H * DH:(i + 1) * H * DH].view(B, T, H, DH) for i in range(3))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    got = K1.rel_attention(q_u, k, v, q_rot, k_std, lengths)
    assert _build.LAUNCHES["asr_rel_attention"] == 1 and got.shape == (B, T, H, DH)
    _close(got, K1.rel_attention_plain(q_u, k, v, q_rot, k_std, lengths), 2 ** -6)


WIDE_CASES = [(32, 250, 8, 64, 512, None), (3, 333, 8, 64, 512, [1, 333, 0]), (3, 70, 4, 64, 448, [70, 33, 0]),
              (2, 129, 4, 32, 320, [129, 1]), (3, 250, 8, 64, 256, [250, 1, 167]), (3, 250, 8, 32, 256, [250, 1, 167])]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,T,H,DH,D,lens", WIDE_CASES)
def test_train_attention_past_288_columns(B, T, H, DH, D, lens, rate):
    """K4 forward and backward in bf16 where the dq kernel's [dq_u | dq_rot]
    passes its registers (dh + D > 288: dS written, dq_rot by the GEMM) and
    past 256 columns of q_rot (the chunk ring): the 512-wide config's step
    (B=32, T=250, head 64, q_rot 512), lengths 0 and 1, widths 320 and 448;
    (32, 256) keeps the register path. Tolerances as at 256."""
    dev = _cuda()
    g = torch.Generator().manual_seed(T + D + DH)
    mk = lambda *s: torch.randn(*s, generator=g).bfloat16().to(dev)  # noqa: E731
    q_u, q_rot, k, v, k_std, cot = mk(B, T, H, DH), mk(B, T, H, D) * 0.25, mk(B, T, H, DH), mk(B, T, H, DH), \
        mk(T, D), mk(B, T, H, DH)
    lens = lens or [T - (7 * b) % 40 for b in range(B)]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q_u, q_rot, k, v)]
        out = fn(*leaves, k_std, lengths, 77, rate)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, cot))

    _build.reset_launch_counts()
    got = run(rel_attention_train)
    wide = DH + D > 288
    assert _build.LAUNCHES["asr_rel_attention_train_fwd"] == 1
    assert _build.LAUNCHES["asr_rel_attention_train_bwd"] == 1
    assert _build.LAUNCHES["asr_gemm_bf16"] == int(wide)
    for name, gt, r in zip(("out", "dq_u", "dq_rot", "dk", "dv"), got, run(rel_attention_train_plain)):
        assert gt.dtype == torch.bfloat16 and gt.shape == r.shape, name
        _close(gt, r, ATT_TOL[torch.bfloat16])
    # keys past every row's visited keys get exact zeros
    for b, n in enumerate(lens):
        if 0 < n < T:
            assert not bool(got[3][b, n:].any()) and not bool(got[4][b, n:].any())


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T,lens", [(250, [250, 1, 0, 167]), (333, [333, 1, 0, 200]), (70, [70, 1, 0])])
@pytest.mark.parametrize("DH,D", [(64, 512), (64, 464), (32, 512), (40, 312), (32, 256)])
def test_train_attention_fp32_past_256_columns(DH, D, T, lens, rate):
    """fp32 K4 forward and its four gradients at the widths the fp32 kernels
    stream through their chunk ring: the 512-wide config's (64, 512), 464, a
    head of 32 at 512, (40, 312), which the wrapper pads to (64, 320), and the
    flagship's (32, 256); rows of length 1 and 0, one ragged key tile at T=70.
    fp32 tolerance as at 256."""
    dev = _cuda()
    B, H = len(lens), 4
    g = torch.Generator().manual_seed(T + D + DH)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
    q_u, q_rot, k, v, k_std, cot = mk(B, T, H, DH), mk(B, T, H, D) * 0.25, mk(B, T, H, DH), mk(B, T, H, DH), \
        mk(T, D), mk(B, T, H, DH)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q_u, q_rot, k, v)]
        out = fn(*leaves, k_std, lengths, 77, rate)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, cot))

    _build.reset_launch_counts()
    got = run(rel_attention_train)
    assert dict(_build.LAUNCHES) == {"asr_rel_attention_train_fwd": 1, "asr_rel_attention_train_bwd": 1}
    for name, gt, r in zip(("out", "dq_u", "dq_rot", "dk", "dv"), got, run(rel_attention_train_plain)):
        assert gt.dtype == torch.float32 and gt.shape == r.shape, name
        _close(gt, r, ATT_TOL[torch.float32])
    # a row of length 1 sends gradient to its first key only
    assert not bool(got[3][1, 1:].any()) and not bool(got[4][1, 1:].any())


@pytest.mark.parametrize("T,lens", [(250, [250, 1, 0, 167, 250, 200, 64, 65]), (333, [333, 1, 0, 200])])
def test_train_attention_fp32_at_the_flagship_shape(T, lens):
    """fp32 K4 at the flagship's attention (8 heads of 32, q_rot 256), rate
    0.1, ragged lengths with rows of length 1 and 0: out and the four
    gradients within the fp32 tolerance; the backward's dS scratch leaves the
    gradients of the keys past every row's length at exact zeros."""
    dev = _cuda()
    B, H, DH, D = len(lens), 8, 32, 256
    g = torch.Generator().manual_seed(T + 32)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
    q_u, q_rot, k, v, k_std, cot = mk(B, T, H, DH), mk(B, T, H, D) * 0.25, mk(B, T, H, DH), mk(B, T, H, DH), \
        mk(T, D), mk(B, T, H, DH)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q_u, q_rot, k, v)]
        out = fn(*leaves, k_std, lengths, 31, 0.1)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, cot))

    _build.reset_launch_counts()
    got = run(rel_attention_train)
    assert dict(_build.LAUNCHES) == {"asr_rel_attention_train_fwd": 1, "asr_rel_attention_train_bwd": 1}
    for name, gt, r in zip(("out", "dq_u", "dq_rot", "dk", "dv"), got, run(rel_attention_train_plain)):
        assert gt.dtype == torch.float32 and gt.shape == r.shape, name
        _close(gt, r, ATT_TOL[torch.float32])
    for b, n in enumerate(lens):
        if 0 < n < T:
            assert not bool(got[3][b, n:].any()) and not bool(got[4][b, n:].any())


@pytest.mark.parametrize("dtype,H,DH,D", [(torch.float32, 4, 32, 128), (torch.bfloat16, 4, 32, 128),
                                          (torch.bfloat16, 8, 64, 512)])
def test_train_attention_row0_numbers_the_dropout_rows(dtype, H, DH, D):
    """A data-parallel rank's call (``row0`` = its first row of the global
    batch, rate 0.1): the forward and the four gradients within tolerance of
    the plain version with the same ``row0``, and equal bit for bit to the
    rank's rows of the call on the whole global batch."""
    dev = _cuda()
    B, T, start = 4, 129, 2
    g = torch.Generator().manual_seed(D + DH)
    mk = lambda *s: torch.randn(*s, generator=g).to(dtype).to(dev)  # noqa: E731
    q_u, q_rot, k, v, k_std, cot = mk(B, T, H, DH), mk(B, T, H, D) * 0.25, mk(B, T, H, DH), mk(B, T, H, DH), \
        mk(T, D), mk(B, T, H, DH)
    lengths = torch.tensor([129, 1, 100, 0], dtype=torch.int32, device=dev)

    def run(fn, rows, row0):
        leaves = [t[rows].clone().requires_grad_(True) for t in (q_u, q_rot, k, v)]
        out = fn(*leaves, k_std, lengths[rows].clone(), 4242, 0.1, row0=row0)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, cot[rows]))

    part = slice(start, B)
    got = run(rel_attention_train, part, start)
    for name, gt, r in zip(("out", "dq_u", "dq_rot", "dk", "dv"), got, run(rel_attention_train_plain, part, start)):
        _close(gt, r, ATT_TOL[dtype])
    whole = run(rel_attention_train, slice(None), 0)
    for name, gt, w in zip(("out", "dq_u", "dq_rot", "dk", "dv"), got, whole):
        assert torch.equal(gt, w[part]), name


@pytest.mark.parametrize("t_valid", ["ragged", 1, "T", 0])
@pytest.mark.parametrize("B,T", [(1, 56), (8, 256), (128, 256), (3, 70)])
@pytest.mark.parametrize("C", [1024, 896, 768])
def test_dwconv_csgu_past_768_channels(C, B, T, t_valid):
    """The CSGU conv of the 512-wide config (C = 1,024, K = 31) in 128-channel
    slices behind the row-statistics pass, at t_valid 0, 1, ragged and T, both
    tilings; 896 is the other width of the sliced path, 768 the widest of the
    whole-row tiles. Also as a row view."""
    dev = _cuda()
    tv = {"ragged": T - 5, "T": T}.get(t_valid, t_valid)
    args = _dw_inputs(dev, 0, B, T, C, 31, seed=C + B + T, lead=64 if B == 3 else 0)
    _build.reset_launch_counts()
    got, ref = _dw_both(0, *args, B, T, tv, act="identity")
    assert sum(_build.LAUNCHES.values()) == 1
    _close(got, ref, 2 ** -7)
    if B == 8:
        _close(*_dw_both(0, *args, B, T, tv, act="swish"), 2 ** -7)


@pytest.mark.parametrize("t_valid", ["ragged", 1, "T", 0])
@pytest.mark.parametrize("B,T", [(1, 56), (8, 256), (128, 256), (3, 70)])
def test_dwconv_merge_at_1024_channels(B, T, t_valid):
    """The merge conv of the 512-wide config (2D = 1,024 channels, K = 31) at
    t_valid 0, 1, ragged and T, both tilings; at (3, 70) as a row view."""
    dev = _cuda()
    tv = {"ragged": T - 5, "T": T}.get(t_valid, t_valid)
    args = _dw_inputs(dev, 1, B, T, 1024, 31, seed=1024 + B + T, lead=64 if B == 3 else 0)
    _build.reset_launch_counts()
    got, ref = _dw_both(1, *args, B, T, tv)
    assert sum(_build.LAUNCHES.values()) == 1
    _close(got, ref, 2 ** -7)


WIDE = EBranchformerConfig(
    hidden_size=512, num_hidden_layers=2, num_attention_heads=8, intermediate_size=2048, conv_dim=(512, 512),
    vocab_size=50,
)


@pytest.fixture(scope="module")
def wide():
    model = init_random_(EBranchformerForCTC(WIDE).eval(), torch.Generator().manual_seed(512))
    return model, FusedCTC(model, "cuda") if torch.cuda.is_available() else None


@pytest.mark.parametrize("B,T,t_valid,lens", [(3, 72, 70, [70, 1, 0]), (8, 256, 250, [250, 200, 1, 0, 64, 65, 128, 3])])
def test_layer_pieces_and_layer_at_512_wide(wide, B, T, t_valid, lens):
    """Every piece of a 512-wide layer (heads of 64, q_rot 512, I = 2,048) on
    the fold's operands against its plain version: the LayerNorm, each GEMM,
    pos_query, the attention, the CSGU conv at 1,024 channels, the merge conv
    at 1,024, and the whole layer."""
    dev = _cuda()
    _, fm = wide
    w, D, H = fm.layers[0], WIDE.hidden_size, WIDE.num_attention_heads
    assert (w["wp"].shape[2], K1.rot_width(D)) == (64, 512)
    g = torch.Generator().manual_seed(B + T)
    x = torch.randn(B, T, D, generator=g).bfloat16().to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    tables = fm.tables(T)
    M, xf = B * T, x.view(B * T, D)
    ln = K1.layer_norm(xf, w["ff1_ln_g"], w["ff1_ln_b"], 1e-5)
    _close(ln, K1.layer_norm_plain(xf, w["ff1_ln_g"], w["ff1_ln_b"], 1e-5), 2 ** -7)
    h = K1.gemm(ln, w["ff1_wi"], w["ff1_bi"], act="gelu")  # K = 512, N = 2,048
    _close(h, K1.gemm_plain(ln, w["ff1_wi"], w["ff1_bi"], act="gelu"), 2 ** -6)
    _close(K1.gemm(h, w["ff1_wo"], w["ff1_bo"], residual=xf, alpha=0.5),  # K = 2,048
           K1.gemm_plain(h, w["ff1_wo"], w["ff1_bo"], residual=xf, alpha=0.5), 2 ** -6)
    qkv, q_v = K1.gemm(ln, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])  # N = 1,536
    ref_qkv, ref_q_v = K1.gemm_plain(ln, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])
    _close(qkv, ref_qkv, 2 ** -6)
    _close(q_v, ref_q_v, 2 ** -6)
    q_rot = K1.pos_query(q_v, w["wp"], tables["rot_cos"], tables["rot_sin"], T)
    _close(q_rot, K1.pos_query_plain(q_v, w["wp"], tables["rot_cos"], tables["rot_sin"], T), 2 ** -7)
    hv = lambda i: qkv[:, i * D:(i + 1) * D].view(B, T, H, 64)  # noqa: E731
    args = (hv(0), hv(1), hv(2), q_rot.view(B, T, H, D), tables["k_std"], lengths)
    attn = K1.rel_attention(*args)
    _close(attn, K1.rel_attention_plain(*args), 2 ** -6)
    l = K1.gemm(ln, w["cg_w1"], w["cg_b1"], act="gelu")  # N = 2,048
    _close(l, K1.gemm_plain(ln, w["cg_w1"], w["cg_b1"], act="gelu"), 2 ** -6)
    cargs = (w["csgu_ln_g"], w["csgu_ln_b"], w["csgu_dw"], w["csgu_dw_b"], B, T, t_valid, WIDE.csgu_activation, 1e-5)
    gated = K1.csgu(l, *cargs)
    _close(gated, K1.csgu_plain(l, *cargs), 2 ** -7)
    # the out projection and cg_w2 (K = 1,024) into the two halves of `merged`
    merged = torch.full((M + 8, 2 * D), 7.0, dtype=torch.bfloat16, device=dev)
    K1.gemm(attn.view(M, D), w["wo"], w["bo"], out=merged[:M, :D])
    K1.gemm(gated, w["cg_w2"], w["cg_b2"], out=merged[:M, D:])
    assert bool((merged[M:] == 7.0).all())
    _close(merged[:M, :D], K1.gemm_plain(attn.view(M, D), w["wo"], w["bo"]), 2 ** -6)
    _close(merged[:M, D:], K1.gemm_plain(gated, w["cg_w2"], w["cg_b2"]), 2 ** -6)
    margs = (w["merge_dw"], w["merge_dw_b"], B, T, t_valid)
    mixed = K1.merge_conv(merged[:M], *margs)  # 1,024 channels
    _close(mixed, K1.merge_conv_plain(merged[:M], *margs), 2 ** -7)
    _close(K1.gemm(mixed, w["merge_w"], w["merge_b"], residual=xf, alpha=1.0),  # K = 1,024
           K1.gemm_plain(mixed, w["merge_w"], w["merge_b"], residual=xf, alpha=1.0), 2 ** -6)
    _close(K1.ebranchformer_layer(x, lengths, w, WIDE, t_valid, tables),
           K1.ebranchformer_layer_plain(x, lengths, w, WIDE, t_valid, tables), 0.05)


def test_attention_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _cuda()
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device=dev)  # noqa: E731
    lengths = torch.tensor([8], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # a head past 64 columns (16 and 44 are padded)
        rel_attention_train(z(1, 8, 2, 96), z(1, 8, 2, 64), z(1, 8, 2, 96), z(1, 8, 2, 96), z(8, 64),
                            lengths, 0, 0.0)
    with pytest.raises(ValueError):  # q_rot past 512 columns (48 is padded to 64)
        rel_attention_train(z(1, 8, 2, 32), z(1, 8, 2, 576), z(1, 8, 2, 32), z(1, 8, 2, 32), z(8, 576),
                            lengths, 0, 0.0)
    with pytest.raises(ValueError):  # fp32 q_rot past 512 columns
        rel_attention_train(z(1, 8, 2, 32).float(), z(1, 8, 2, 528).float(), z(1, 8, 2, 32).float(),
                            z(1, 8, 2, 32).float(), z(8, 528).float(), lengths, 0, 0.0)
    with pytest.raises(ValueError):  # the shift form: a head past 64 columns
        rel_attention(z(1, 8, 2, 96), z(1, 8, 2, 96), z(1, 8, 2, 96), z(1, 8, 2, 96), z(15, 2, 96), lengths)
    with pytest.raises(ValueError):  # lengths on the CPU
        rel_attention(z(1, 8, 2, 32), z(1, 8, 2, 32), z(1, 8, 2, 32), z(1, 8, 2, 32), z(15, 2, 32),
                      lengths.cpu())
    with pytest.raises(ValueError):  # int64 lengths
        rel_attention(z(1, 8, 2, 32), z(1, 8, 2, 32), z(1, 8, 2, 32), z(1, 8, 2, 32), z(15, 2, 32),
                      lengths.long())


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _cuda()
    g, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(ValueError):
        K1.layer_norm(torch.zeros(8, 64, device=dev), g, b, 1e-5)  # fp32 rows
    with pytest.raises(ValueError):
        K1.gemm(torch.zeros(8, 64, dtype=torch.bfloat16, device=dev),
                torch.zeros(64, 36, dtype=torch.bfloat16, device=dev))  # N % 8
    with pytest.raises(ValueError):
        K1.layer_norm(torch.zeros(8, 64, dtype=torch.bfloat16, device=dev), g.cpu(), b, 1e-5)
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device=dev)  # noqa: E731
    refused = [
        dict(a=z(8, 44), w=z(44, 64)),                              # K % 8
        dict(a=z(8, 68)[:, :64], w=z(64, 64)),                      # a's row stride
        dict(a=z(8, 72)[:, 4:68], w=z(64, 64)),                     # a's base address
        dict(a=z(8, 64), w=z(64, 64), out=z(8, 72)[:, 4:68]),       # out's base address
        dict(a=z(8, 64), w=z(64, 64), residual=z(8, 68)[:, :64]),   # the residual's row stride
        dict(a=z(8, 64), w=z(64, 64), bias2=torch.zeros(20, device=dev)),
        dict(a=z(8, 64).float(), w=z(64, 64)),                      # fp32 rows
        dict(a=z(8, 64), w=z(64, 128)[:, :64]),                     # a weight that is not contiguous
    ]
    for kw in refused:
        with pytest.raises(ValueError):
            K1.gemm(kw.pop("a"), kw.pop("w"), None, **kw)
    with pytest.raises(ValueError):  # conv2 holds all C == 256 output channels in one block
        K2.conv2(torch.zeros(1, 7, 40, 64, dtype=torch.bfloat16, device=dev),
                 torch.zeros(9 * 64, 64, dtype=torch.bfloat16, device=dev), torch.zeros(64, device=dev), 8)


def test_port_modules_import_nothing_of_jax():
    """Needs no card: after importing every module of the port's training
    slice in a fresh interpreter, no jax, flax, optax, orbax or
    huggingface_asr_tpu module is loaded."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys; sys.path.insert(0, %r)\n"
        "import huggingface_asr_tpu_torch.training.loop, huggingface_asr_tpu_torch.training.optim\n"
        "import huggingface_asr_tpu_torch.training.train_state, huggingface_asr_tpu_torch.training.model_factory\n"
        "import huggingface_asr_tpu_torch.kernels.train_attention, huggingface_asr_tpu_torch.kernels.attention\n"
        "import huggingface_asr_tpu_torch.ops.spec_augment, huggingface_asr_tpu_torch.ops.ctc\n"
        "import huggingface_asr_tpu_torch.data.synthetic_speech, huggingface_asr_tpu_torch.data.bucketing\n"
        "import huggingface_asr_tpu_torch.data.collator, huggingface_asr_tpu_torch.data.prefetch\n"
        "import huggingface_asr_tpu_torch.utils.metrics, huggingface_asr_tpu_torch.utils.logging_utils\n"
        "import huggingface_asr_tpu_torch.utils.device, huggingface_asr_tpu_torch.interop.from_jax\n"
        "import huggingface_asr_tpu_torch.serving.pipeline, huggingface_asr_tpu_torch.cli.pretrain\n"
        "import huggingface_asr_tpu_torch.models.bestrq, huggingface_asr_tpu_torch.ops.masking\n"
        "import huggingface_asr_tpu_torch.models.wav2vec2_ssl, huggingface_asr_tpu_torch.cli.train_ctc\n"
        "import huggingface_asr_tpu_torch.models.llm_asr, huggingface_asr_tpu_torch.models.whisper_seq2seq\n"
        "import huggingface_asr_tpu_torch.interop.hf_whisper, huggingface_asr_tpu_torch.cli.train_aed\n"
        "import huggingface_asr_tpu_torch.serving.streaming, huggingface_asr_tpu_torch.decoding.ctc_beam\n"
        "import huggingface_asr_tpu_torch.parallel.mesh, huggingface_asr_tpu_torch.parallel.distributed\n"
        "import huggingface_asr_tpu_torch.data.builders, huggingface_asr_tpu_torch.data.native_collate\n"
        "import huggingface_asr_tpu_torch.interop.publish, huggingface_asr_tpu_torch.cli.publish_model\n"
        "import huggingface_asr_tpu_torch.cli.compute_dataset_statistics, huggingface_asr_tpu_torch.cli.train_clm\n"
        "import huggingface_asr_tpu_torch.cli.preprocess_dataset, huggingface_asr_tpu_torch.cli.train_tokenizer\n"
        "import huggingface_asr_tpu_torch.cli.init_model_configs\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'huggingface_asr_tpu'))\n"
        "assert not bad, bad\nprint('ok')\n" % repo
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
                         cwd=repo, env=env)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


# ---- the 176-wide configs: head size 44 (padded to 64 columns), q_rot width
# 176 (padded to 192), the GEMM's edge tiles at N = 176 and K = 176, and K1
# behind the model's own conv front end (conv_dim (176, 176))

NARROW = EBranchformerConfig(
    hidden_size=176, num_hidden_layers=2, num_attention_heads=4, intermediate_size=704, conv_dim=(176, 176),
    vocab_size=50,
)


@pytest.fixture(scope="module")
def narrow():
    model = init_random_(EBranchformerForCTC(NARROW).eval(), torch.Generator().manual_seed(7))
    return model, FusedCTC(model, "cuda") if torch.cuda.is_available() else None


@pytest.mark.parametrize("B,T,t_valid,lens", [(3, 72, 70, [70, 1, 0]), (8, 256, 250, [250, 200, 1, 0, 64, 65, 128, 3])])
def test_layer_pieces_and_layer_at_head_size_44(narrow, B, T, t_valid, lens):
    """Every piece of a 176-wide layer on the fold's padded operands, and the
    whole layer, against their plain versions; q_rot's pad columns are zeros
    the kernel wrote, and the attention output's pad columns are zero."""
    dev = _cuda()
    _, fm = narrow
    w, D, H = fm.layers[0], NARROW.hidden_size, NARROW.num_attention_heads
    hw, d_rot = w["wp"].shape[2], K1.rot_width(D)
    assert (hw, d_rot) == (64, 192)
    g = torch.Generator().manual_seed(B + T)
    x = torch.randn(B, T, D, generator=g).bfloat16().to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    tables = fm.tables(T)
    xf = x.view(B * T, D)
    qkv, q_v = K1.gemm(xf, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])  # K = 176
    ref_qkv, ref_q_v = K1.gemm_plain(xf, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])
    _close(qkv, ref_qkv, 2 ** -6)
    _close(q_v, ref_q_v, 2 ** -6)
    q_rot = K1.pos_query(q_v, w["wp"], tables["rot_cos"], tables["rot_sin"], T)
    pad = (d_rot - D) // 2
    assert not q_rot[..., D // 2:D // 2 + pad].any() and not q_rot[..., d_rot - pad:].any()
    _close(q_rot, K1.pos_query_plain(q_v, w["wp"], tables["rot_cos"], tables["rot_sin"], T), 2 ** -7)
    hv = lambda i: qkv[:, i * H * hw:(i + 1) * H * hw].view(B, T, H, hw)  # noqa: E731
    args = (hv(0), hv(1), hv(2), q_rot.view(B, T, H, d_rot), tables["k_std"], lengths)
    _build.reset_launch_counts()
    attn = K1.rel_attention(*args)
    assert _build.LAUNCHES["asr_rel_attention"] == 1 and attn.shape == (B, T, H, hw)
    _close(attn, K1.rel_attention_plain(*args), 2 ** -6)
    assert not attn[..., 44:].any()
    # the out projection (K = 256, N = 176) and cg_w2 (K = 352, N = 176) into
    # the two halves of `merged`, 352 bytes apart, with guard rows after them
    merged = torch.full((B * T + 8, 2 * D), 7.0, dtype=torch.bfloat16, device=dev)
    K1.gemm(attn.view(B * T, H * hw), w["wo"], w["bo"], out=merged[:B * T, :D])
    assert bool((merged[:B * T, D:] == 7.0).all())
    gated = torch.randn(B * T, NARROW.intermediate_size // 2, generator=g).bfloat16().to(dev)
    K1.gemm(gated, w["cg_w2"], w["cg_b2"], out=merged[:B * T, D:])
    assert bool((merged[B * T:] == 7.0).all())
    _close(merged[:B * T, :D], K1.gemm_plain(attn.view(B * T, H * hw), w["wo"], w["bo"]), 2 ** -6)
    _close(merged[:B * T, D:], K1.gemm_plain(gated, w["cg_w2"], w["cg_b2"]), 2 ** -6)
    _close(K1.ebranchformer_layer(x, lengths, w, NARROW, t_valid, tables),
           K1.ebranchformer_layer_plain(x, lengths, w, NARROW, t_valid, tables), 0.05)


@pytest.mark.parametrize("M", [56, 2048, 32768])
def test_gemm_edge_tiles_at_176(M):
    """N = 176 and K = 176 (and K = 704, 352) in both tile kernels (M = 56 and
    2,048 take the small tile, 32,768 the large one), every epilogue, into a
    column slice of a buffer whose other columns and rows past M must stay
    untouched."""
    dev = _cuda()
    g = torch.Generator().manual_seed(M)
    mk = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dev)  # noqa: E731
    for K, N, kw in ((176, 704, dict(act="gelu")), (704, 176, dict(residual=True)), (176, 528, dict(dual=True)),
                     (352, 176, dict()), (176, 176, dict(act="swish"))):
        a, wt, bias = mk(M, K).bfloat16(), mk(K, N, scale=K ** -0.5).bfloat16(), mk(N, scale=0.1)
        extra = {}
        if kw.get("act"):
            extra["act"] = kw["act"]
        if kw.get("residual"):
            extra.update(residual=mk(M, N).bfloat16(), alpha=0.5)
        if kw.get("dual"):
            extra["bias2"] = mk(176, scale=0.1)
        guard = torch.full((M + 8, N + 64), 7.0, dtype=torch.bfloat16, device=dev)
        got = K1.gemm(a, wt, bias, out=guard[:M, 32:32 + N], **extra)
        ref = K1.gemm_plain(a, wt, bias, **extra)
        torch.cuda.synchronize()
        if kw.get("dual"):
            _close(got[1], ref[1], 2 ** -6)
            got, ref = got[0], ref[0]
        _close(got, ref, 2 ** -6)
        assert bool((guard[:, :32] == 7.0).all()) and bool((guard[:, 32 + N:] == 7.0).all()), (K, N)
        assert bool((guard[M:] == 7.0).all()), (K, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T,lens", [(250, [250, 1, 0, 167]), (333, [333, 1, 0, 200])])
def test_train_attention_at_head_size_44(dtype, rate, T, lens):
    """K4 forward and all four gradients at dh 44 and D 176 (the wrapper pads
    to 64 and 192 in bf16, to 64 and 176 in fp32) against the plain version on
    the unpadded operands."""
    dev = _cuda()
    B, H, dh, D = len(lens), 4, 44, 176
    g = torch.Generator().manual_seed(T)
    mk = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dtype).to(dev)  # noqa: E731
    q_u, q_rot, k, v, k_std, cot = (mk(B, T, H, dh), mk(B, T, H, D, scale=0.25), mk(B, T, H, dh), mk(B, T, H, dh),
                                    mk(T, D), mk(B, T, H, dh))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q_u, q_rot, k, v)]
        out = fn(*leaves, k_std, lengths, 4242, rate)
        out.backward(cot)
        return [out.detach()] + [t.grad for t in leaves]

    _build.reset_launch_counts()
    got = run(rel_attention_train)
    assert _build.LAUNCHES["asr_rel_attention_train_fwd"] == 1 and _build.LAUNCHES["asr_rel_attention_train_bwd"] == 1
    ref = run(rel_attention_train_plain)
    for name, gt, r in zip(("out", "dq_u", "dq_rot", "dk", "dv"), got, ref):
        assert gt.dtype == dtype and gt.shape == r.shape, name
        _close(gt, r, ATT_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,lens", [(70, [70, 33, 0]), (250, [250, 1, 0, 200])])
def test_shift_attention_at_head_size_44(dtype, T, lens):
    dev = _cuda()
    B, H, dh = len(lens), 4, 44
    g = torch.Generator().manual_seed(T)
    mk = lambda *s: torch.randn(*s, generator=g).to(dtype).to(dev)  # noqa: E731
    args = (mk(B, T, H, dh), mk(B, T, H, dh), mk(B, T, H, dh), mk(B, T, H, dh), mk(2 * T - 1, H, dh),
            torch.tensor(lens, dtype=torch.int32, device=dev))
    _build.reset_launch_counts()
    got = rel_attention(*args)
    assert _build.LAUNCHES["asr_rel_attention_shift"] == 1 and got.shape == (B, T, H, dh)
    _close(got, rel_attention_plain_shift(*args), ATT_TOL[dtype])


def test_ctc_infer_behind_the_model_front_end(narrow):
    """A 176-wide model: the model's conv front end in bf16, then the K1
    layers, against the plain path; each layer launches its attention and
    positional query once and both convs once."""
    dev = _cuda()
    _, fm = narrow
    feats = torch.randn(3, 300, 80, generator=torch.Generator().manual_seed(8)).to(dev)
    lens = torch.tensor([300, 1, 0], dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    got, hidden = ctc_infer(fm, feats, lens, return_hidden=True)
    n = NARROW.num_hidden_layers
    assert all(_build.LAUNCHES[k] == n for k in ("asr_rel_attention", "asr_pos_query", "dwconv_csgu", "dwconv_merge"))
    assert _build.LAUNCHES["asr_conv1"] == 0 and hidden.shape == (3, got.logits.shape[1], NARROW.hidden_size)
    ref = ctc_infer(fm, feats, lens, plain=True)
    assert torch.equal(got.logit_lengths, ref.logit_lengths)
    _close(got.logits, ref.logits, 0.05)


def test_pipeline_serves_a_176_wide_model_through_the_kernels(narrow, tmp_path):
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from huggingface_asr_tpu_torch.training.model_factory import save_params

    _cuda()
    save_params(narrow[0], str(tmp_path))

    class Ids:
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(map(str, ids))

    audios = [np.zeros(16000, np.float32), np.ones(24000, np.float32) * 0.01]
    pipe = ASRPipeline(str(tmp_path), model_type="ctc", device="cuda", tokenizer=Ids())  # the serving profile
    assert pipe._use_fused and pipe.numeric_profile == "serving"
    _build.reset_launch_counts()
    texts = pipe(audios)
    assert len(texts) == 2 and _build.LAUNCHES["asr_rel_attention_serving"] == NARROW.num_hidden_layers
    pipe = ASRPipeline(str(tmp_path), model_type="ctc", device="cuda", tokenizer=Ids(), numeric_profile="exact")
    _build.reset_launch_counts()
    texts = pipe(audios)
    assert len(texts) == 2 and _build.LAUNCHES["asr_rel_attention"] == NARROW.num_hidden_layers


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_training_step_of_a_176_wide_model_takes_the_kernels(impl):
    """The config default "auto" trains a 176-wide model on K4 (it raised
    before): a training forward and backward with the CTC loss launch the
    forward and backward kernels once per layer; the gradients are finite."""
    from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng

    dev = _cuda()
    cfg = dataclasses.replace(NARROW, attention_impl=impl, attention_dropout=0.1)
    model = init_random_(EBranchformerForCTC(cfg), torch.Generator().manual_seed(0)).to(dev)
    feats = torch.randn(2, 200, 80, generator=torch.Generator().manual_seed(1)).to(dev)
    lens = torch.tensor([200, 120], dtype=torch.int32, device=dev)
    labels = torch.randint(0, 50, (2, 12), generator=torch.Generator().manual_seed(2)).to(dev)
    label_lens = torch.tensor([12, 7], dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    out = model(feats.bfloat16(), lens, labels, label_lens, rng=DropoutRng(0, dev))
    out.loss.backward()
    n = cfg.num_hidden_layers
    assert _build.LAUNCHES["asr_rel_attention_train_fwd"] == n and _build.LAUNCHES["asr_rel_attention_train_bwd"] == n
    assert bool(torch.isfinite(out.loss)) and all(bool(torch.isfinite(p.grad).all())
                                                 for p in model.parameters() if p.grad is not None)


def test_aed_pipeline_takes_the_kernel_route(tmp_path):
    """The AED route on the card: the encoder runs K2 and one K1 sequence a
    layer behind the plain log-mel front end (no mel kernel), and the search
    on the kernel route's outputs returns bos-led sequences, best first."""
    from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig
    from huggingface_asr_tpu_torch.models.joint_ctc_aed import (
        JointCTCAttentionConfig,
        JointCTCAttentionEncoderDecoder,
    )
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from huggingface_asr_tpu_torch.training.model_factory import save_params

    _cuda()
    cfg = JointCTCAttentionConfig(
        encoder=EBranchformerConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
                                    csgu_kernel_size=7, merge_conv_kernel=7, vocab_size=80),
        decoder=GPT2DecoderConfig(vocab_size=80, n_embd=64, n_layer=2, n_head=2, n_positions=64))
    save_params(init_random_(JointCTCAttentionEncoderDecoder(cfg), torch.Generator().manual_seed(0)), str(tmp_path))

    class Table:
        bos_token_id, eos_token_id, pad_token_id, unk_token_id = 0, 1, 3, 2

        def __len__(self):
            return 80

        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(i) for i in ids if i > 3)

    pipe = ASRPipeline(str(tmp_path), device="cuda", tokenizer=Table(), max_length=16)
    assert pipe.model_type == "aed" and pipe._use_fused
    rng = np.random.default_rng(0)
    audios = [utterance(s, rng)[0] for s in (3.0, 4.5)]
    _build.reset_launch_counts()
    texts = pipe(audios)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert len(texts) == 2
    assert launches.get("asr_rel_attention") == 2 and launches.get("asr_conv2") == 1
    assert not launches.get("asr_log_mel")


def _decred_widths(attention_impl="auto"):
    """configs/decred_base.json's widths (encoder 256 x 8 heads, I 1024,
    256 x 256 subsampler; decoder 256 x 4 heads, a head after layer 1 of 2),
    two layers each, vocabulary 500."""
    from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig
    from huggingface_asr_tpu_torch.models.joint_ctc_aed import JointCTCAttentionConfig

    return JointCTCAttentionConfig(
        encoder=EBranchformerConfig(hidden_size=256, num_hidden_layers=2, num_attention_heads=8,
                                    intermediate_size=1024, csgu_kernel_size=31, merge_conv_kernel=31,
                                    vocab_size=500, attention_impl=attention_impl),
        decoder=GPT2DecoderConfig(vocab_size=500, n_embd=256, n_layer=2, n_head=4, n_positions=512,
                                  head_locations=(1,), head_weights=(0.3, 0.7), lsm_factor=0.1,
                                  bos_token_id=0, eos_token_id=1, pad_token_id=3))


def test_joint_trainer_step_on_k4_agrees_with_the_plain_attention():
    """One JointTrainer step at decred widths (bf16 over fp32 weights,
    dropout on, from the Flax-matching initialiser), "auto": K4 forward and
    backward once per encoder layer; the same step with the plain attention
    gives the loss within 1e-4 and the gradient norm within 1e-3 (relative),
    as the smoke's training phases hold them."""
    import copy

    from huggingface_asr_tpu_torch.models import ebranchformer as model_module
    from huggingface_asr_tpu_torch.models.joint_ctc_aed import init_joint_from_scratch_
    from huggingface_asr_tpu_torch.training.loop import JointTrainer, TrainerConfig
    from huggingface_asr_tpu_torch.training.model_factory import instantiate_aed_model
    from huggingface_asr_tpu_torch.training.optim import OptimizerConfig

    dev = _cuda()
    cfg = _decred_widths()
    model = init_joint_from_scratch_(instantiate_aed_model(cfg, dtype=torch.bfloat16)[0],
                                     torch.Generator().manual_seed(0))
    twin = copy.deepcopy(model)
    tcfg = TrainerConfig(optimizer=OptimizerConfig(learning_rate=1e-4, warmup_steps=1, total_steps=10),
                         spec_augment=None)
    rng = np.random.default_rng(0)
    batch = {"input_features": rng.standard_normal((4, 600, 80)).astype(np.float32),
             "input_lengths": np.asarray([600, 555, 431, 300], np.int32),
             "labels": rng.integers(4, 500, (4, 24)).astype(np.int32),
             "label_lengths": np.asarray([24, 20, 13, 9], np.int32)}
    trainer = JointTrainer(model, tcfg, device=dev, dtype="bfloat16")
    _build.reset_launch_counts()
    _, m = trainer.train_step(trainer.init_state(), batch)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["asr_rel_attention_train_fwd"] == 2 and _build.LAUNCHES["asr_rel_attention_train_bwd"] == 2
    plain = JointTrainer(twin, tcfg, device=dev, dtype="bfloat16")
    orig = model_module.rel_attention_train
    model_module.rel_attention_train = rel_attention_train_plain
    try:
        _build.reset_launch_counts()
        _, m_plain = plain.train_step(plain.init_state(), batch)
        assert not _build.LAUNCHES.get("asr_rel_attention_train_fwd")
    finally:
        model_module.rel_attention_train = orig
    assert int(m["step_applied"]) == 1 and bool(torch.isfinite(m["loss"]))
    assert abs(float(m["loss"]) - float(m_plain["loss"])) <= 1e-4 * abs(float(m_plain["loss"]))
    assert abs(float(m["grad_norm"]) - float(m_plain["grad_norm"])) <= 1e-3 * float(m_plain["grad_norm"])
    for k in ("enc_loss", "dec_loss"):
        assert bool(torch.isfinite(m[k]))


def test_decoder_master_and_serving_layouts_agree_on_the_card():
    """The decoder at decred widths in bf16: fp32 master weights cast at use
    (the trainer's layout) and weights cast once (the serving layout) give
    bit-equal logits, whole-sequence and through the cache."""
    from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2MultiHeadDecoder, init_decoder_from_scratch_

    dev = _cuda()
    cfg = _decred_widths().decoder
    master = GPT2MultiHeadDecoder(cfg, torch.bfloat16, param_dtype=torch.float32)
    init_decoder_from_scratch_(master, torch.Generator().manual_seed(1))
    serving = GPT2MultiHeadDecoder(cfg, torch.bfloat16)
    serving.load_state_dict(master.state_dict(), strict=True)
    master, serving = master.to(dev).eval(), serving.to(dev).eval()
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, 500, (4, 17), generator=g).to(dev)
    enc = torch.randn(4, 120, 256, generator=g).to(dev)
    lens = torch.tensor([120, 97, 64, 3], device=dev)
    with torch.no_grad():
        a, b = master(tokens, enc, lens).logits, serving(tokens, enc, lens).logits
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        ca = master.write_cross_kv(master.init_cache(4, 32, dev), enc)
        cb = serving.write_cross_kv(serving.init_cache(4, 32, dev), enc)
        for t in range(5):
            pos = torch.full((4,), t, device=dev)
            sa = master(tokens[:, t:t + 1], encoder_lengths=lens, position_offset=pos, cache=ca).logits
            sb = serving(tokens[:, t:t + 1], encoder_lengths=lens, position_offset=pos, cache=cb).logits
            assert torch.equal(sa, sb), t


def _wav2vec2_batch(cfg, B=4, T_mel=600, seed=0):
    from huggingface_asr_tpu_torch.models.ebranchformer import feat_extract_output_frames, feat_extract_output_lengths
    from huggingface_asr_tpu_torch.ops.masking import compute_mask_indices, sample_negative_indices

    rng = np.random.default_rng(seed)
    lens = np.asarray([T_mel, 555, 431, 300][:B], np.int32)
    T_enc = int(feat_extract_output_frames(cfg, T_mel))
    mask = compute_mask_indices((B, T_enc), 0.65, 10, lengths=feat_extract_output_lengths(cfg, lens), min_masks=2,
                                rng=rng)
    return {"input_features": rng.standard_normal((B, T_mel, 80)).astype(np.float32), "input_lengths": lens,
            "mask_time_indices": mask, "sampled_negative_indices": sample_negative_indices(mask, cfg.num_negatives,
                                                                                          rng=rng)}


def test_wav2vec2_step_on_k4_agrees_with_the_plain_attention():
    """One Wav2Vec2SSLTrainer step of a 2-layer, 128-wide model from the
    Flax-matching initialiser (bf16 over fp32 weights, attention dropout 0.1,
    the quantizer's default widths),
    attention_impl "pallas": K4 forward and backward once per layer; the same
    step with the plain attention (the same Gumbel draw: the step's augment
    stream) gives the loss within 1e-4 and the gradient norm within 1e-3
    (relative); an evaluation step launches K5 once per layer."""
    import copy

    from huggingface_asr_tpu_torch.models import ebranchformer as model_module
    from huggingface_asr_tpu_torch.models.wav2vec2_ssl import Wav2Vec2ForPreTraining
    from huggingface_asr_tpu_torch.training.loop import TrainerConfig, Wav2Vec2SSLTrainer
    from huggingface_asr_tpu_torch.training.optim import OptimizerConfig

    dev = _cuda()
    cfg = dataclasses.replace(CFG, attention_impl="pallas", num_negatives=20)
    model = Wav2Vec2ForPreTraining(cfg)
    init_from_scratch_(model, torch.Generator().manual_seed(0),
                       lecun_linears=(model.quantizer.weight_proj, model.project_hid, model.project_q))
    twin = copy.deepcopy(model)
    tcfg = TrainerConfig(optimizer=OptimizerConfig(learning_rate=1e-4, warmup_steps=1, total_steps=10),
                         spec_augment=None)
    batch = _wav2vec2_batch(cfg)
    trainer = Wav2Vec2SSLTrainer(model, tcfg, device=dev, dtype="bfloat16")
    _build.reset_launch_counts()
    _, m = trainer.train_step(trainer.init_state(), batch)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["asr_rel_attention_train_fwd"] == 2 and _build.LAUNCHES["asr_rel_attention_train_bwd"] == 2
    plain = Wav2Vec2SSLTrainer(twin, tcfg, device=dev, dtype="bfloat16")
    orig = model_module.rel_attention_train
    model_module.rel_attention_train = rel_attention_train_plain
    try:
        _build.reset_launch_counts()
        _, m_plain = plain.train_step(plain.init_state(), batch)
        assert not _build.LAUNCHES.get("asr_rel_attention_train_fwd")
    finally:
        model_module.rel_attention_train = orig
    assert int(m["step_applied"]) == 1 and bool(torch.isfinite(m["loss"]))
    assert abs(float(m["loss"]) - float(m_plain["loss"])) <= 1e-4 * abs(float(m_plain["loss"]))
    assert abs(float(m["grad_norm"]) - float(m_plain["grad_norm"])) <= 1e-3 * float(m_plain["grad_norm"])
    assert float(m["contrastive_loss"]) > 0 and float(m["codevector_perplexity"]) > 1
    _build.reset_launch_counts()
    assert bool(torch.isfinite(trainer.eval_step(None, batch)["loss"]))
    assert _build.LAUNCHES["asr_rel_attention_shift"] == 2


def test_adapter_model_takes_k4_and_k5_in_the_encoder_layers_only():
    """A CTC model with both BEST-RQ adapters from the Flax-matching
    initialiser, attention_impl "pallas": a
    training step launches K4 once per encoder layer and an inference forward
    K5 once per encoder layer; the additional layer takes the plain attention
    (the Flax model calls it without lengths), and the logits match the model
    on the plain attention throughout."""
    from huggingface_asr_tpu_torch.training.loop import CTCTrainer, TrainerConfig

    dev = _cuda()
    cfg = dataclasses.replace(CFG, attention_impl="pallas", finetune_with_layer_mixing=True,
                              finetune_with_additional_layer=True)
    model = init_from_scratch_(EBranchformerForCTC(cfg), torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((4, 600, 80)).astype(np.float32))
    lens = torch.tensor([600, 555, 431, 300], dtype=torch.int32)
    batch = {"input_features": feats.numpy(), "input_lengths": lens.numpy(),
             "labels": rng.integers(0, 50, (4, 24)).astype(np.int32),
             "label_lengths": np.asarray([24, 20, 13, 9], np.int32)}
    trainer = CTCTrainer(model, TrainerConfig(spec_augment=None), device=dev, dtype="bfloat16")
    _build.reset_launch_counts()
    _, m = trainer.train_step(trainer.init_state(), batch)
    torch.cuda.synchronize()
    assert int(m["step_applied"]) == 1
    assert _build.LAUNCHES["asr_rel_attention_train_fwd"] == 2 and _build.LAUNCHES["asr_rel_attention_train_bwd"] == 2
    model.eval()
    plain = dataclasses.replace(cfg, attention_impl="xla")
    twin = EBranchformerForCTC(plain).to(dev)
    twin.load_state_dict(model.state_dict())
    _build.reset_launch_counts()
    with torch.no_grad():
        got = model(feats.to(dev, torch.bfloat16), lens.to(dev)).logits
        assert _build.LAUNCHES["asr_rel_attention_shift"] == 2
        ref = twin.eval()(feats.to(dev, torch.bfloat16), lens.to(dev)).logits
    _close(got, ref, 0.05)


def test_whisper_ctc_route_takes_the_mel_kernels_and_agrees_with_the_plain_route():
    """The Whisper-CTC decode route on the card, a tiny bf16 model: with
    "auto" one ``mel`` and one ``cmvn`` launch a batch in front of the plain
    transformer; its CTC logits agree with the plain front end's route within
    0.05 of scale and its greedy ids on at least 98 % of the valid frames;
    "on" past ``MEL_MAX_BINS`` (129 mel bins) raises."""
    from huggingface_asr_tpu_torch.cli.evaluate import WhisperCTCRoute
    from huggingface_asr_tpu_torch.models.whisper_ctc import (
        WhisperCTCConfig,
        WhisperEncoderForCTC,
        init_whisper_from_scratch_,
    )

    dev = _cuda()
    cfg = WhisperCTCConfig(d_model=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=128,
                           llm_dim=64, additional_head_count=4, vocab_size=40)
    model = init_whisper_from_scratch_(WhisperEncoderForCTC(cfg), torch.Generator().manual_seed(0)).to(dev).eval()
    rng = np.random.default_rng(0)
    waves = [utterance(s, rng)[0] for s in (4.0, 2.5)]
    S = max(len(w) for w in waves)
    wav = torch.zeros(2, S, device=dev)
    for i, w in enumerate(waves):
        wav[i, :len(w)] = torch.from_numpy(w)
    lens = torch.tensor([len(w) for w in waves], dtype=torch.int32, device=dev)
    fused = WhisperCTCRoute(model, "auto", dev, torch.bfloat16)
    plain = WhisperCTCRoute(model, "off", dev, torch.bfloat16)
    assert fused.fused and not plain.fused
    _build.reset_launch_counts()
    out = fused(wav, lens)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"asr_log_mel": 1, "asr_cmvn": 1}
    ref = plain(wav, lens)
    assert torch.equal(out.logit_lengths, ref.logit_lengths)
    _close(out.logits, ref.logits, 0.05)
    valid = torch.arange(out.logits.shape[1], device=dev)[None, :] < out.logit_lengths[:, None]
    agree = (out.logits.argmax(-1) == ref.logits.argmax(-1))[valid].float().mean()
    assert float(agree) >= 0.98
    wide = WhisperEncoderForCTC(dataclasses.replace(cfg, num_mel_bins=129)).to(dev)
    with pytest.raises(ValueError, match="num_mel_bins 129"):
        WhisperCTCRoute(wide, "on", dev, torch.bfloat16)


# ---- the CSGU linear (csgu_use_linear_after_conv): the ungated CSGU conv
# (mode 2 of asr_dwconv) and the GEMM's gate epilogue (asr_gemm_gate_bf16)


@pytest.mark.parametrize("C,K", [(512, 31), (512, 7), (1024, 31)])
@pytest.mark.parametrize("B,T", [(1, 56), (8, 256), (128, 256)])
def test_dwconv_csgu_ungated_against_plain_and_the_gated_form(B, T, C, K):
    """bf16(dwconv(LN(x_g))) against ``csgu_conv_plain`` (one launch, under
    its own counter), and bit-equal to the gated form's output where x_r is 1
    and the activation the identity (the gated form then rounds the same sum
    once); C = 1,024 takes the 128-channel slices behind the statistics pass."""
    dev = _cuda()
    x, ln_g, ln_b, w, bias = _dw_inputs(dev, 0, B, T, C, K, seed=B + T + C + K)
    tv = T - 5
    _build.reset_launch_counts()
    got = K1.csgu_conv(x, ln_g, ln_b, w, bias, B, T, tv, 1e-5)
    assert dict(_build.LAUNCHES) == {"dwconv_csgu_conv": 1}
    _close(got, K1.csgu_conv_plain(x, ln_g, ln_b, w, bias, B, T, tv, 1e-5), 2 ** -7)
    ones = x.clone()
    ones[:, :C] = 1.0
    gated = K1.csgu(ones, ln_g, ln_b, w, bias, B, T, tv, "identity", 1e-5)
    assert torch.equal(got, gated)


@pytest.mark.parametrize("act", ["identity", "gelu", "swish"])
@pytest.mark.parametrize("M", [56, 2048, 8200, 32768])
def test_gemm_gate_epilogue_against_plain(M, act):
    """bf16(x_r * bf16(act(bf16(a @ w + bias)))) with x_r a column view of a
    (M, 2C) buffer, at the flagship's C = 512, both GEMM kernels, ragged M;
    with x_r = 1 and the identity, bit-equal to the plain epilogue's kernel."""
    dev = _cuda()
    C = 512
    g = torch.Generator().manual_seed(M)
    a = torch.randn(M, C, generator=g).bfloat16().to(dev)
    w = (torch.randn(C, C, generator=g) * C ** -0.5).bfloat16().to(dev)
    bias = torch.randn(C, generator=g).bfloat16().float().to(dev)
    l = torch.randn(M, 2 * C, generator=g).bfloat16().to(dev)
    _build.reset_launch_counts()
    got = K1.gemm(a, w, bias, act=act, gate=l[:, :C])
    assert dict(_build.LAUNCHES) == {"asr_gemm_gate_bf16": 1}
    _close(got, K1.gemm_plain(a, w, bias, act=act, gate=l[:, :C]), 2 ** -6)
    if act == "identity":
        ones = torch.ones(M, 2 * C, dtype=torch.bfloat16, device=dev)[:, :C]
        assert torch.equal(K1.gemm(a, w, bias, gate=ones), K1.gemm(a, w, bias))


def test_csgu_linear_gated_model_on_the_kernel_path():
    """A gated front end (the model's own modules) and the CSGU linear in
    every layer: ``ctc_infer`` launches the ungated conv and the gate epilogue
    once a layer and the gated CSGU conv never, within 0.05 of the scale of
    its plain version."""
    dev = _cuda()
    cfg = dataclasses.replace(CFG, context_awareness_type="gated", csgu_use_linear_after_conv=True,
                              csgu_activation="gelu")
    model = init_random_(EBranchformerForCTC(cfg).eval(), torch.Generator().manual_seed(2))
    fm = FusedCTC(model, dev)
    assert fm.subsample is None
    feats = torch.randn(3, 150, 80, generator=torch.Generator().manual_seed(3)).to(dev)
    lens = torch.tensor([150, 96, 41], dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    got = ctc_infer(fm, feats, lens)
    torch.cuda.synchronize()
    n = cfg.num_hidden_layers
    assert _build.LAUNCHES["dwconv_csgu_conv"] == n and _build.LAUNCHES["asr_gemm_gate_bf16"] == n
    assert "dwconv_csgu" not in _build.LAUNCHES and "asr_conv1" not in _build.LAUNCHES
    ref = ctc_infer(fm, feats, lens, plain=True)
    assert torch.equal(got.logit_lengths, ref.logit_lengths)
    _close(got.logits, ref.logits, 0.05)


def test_ctc_beam_search_on_the_card_matches_the_cpu():
    """The same posteriors on the card and on the CPU: equal n-best ids and
    lengths, scores within 1e-3 (the two devices' exp and log differ in the
    last bits)."""
    from huggingface_asr_tpu_torch.decoding.ctc_beam import CTCBeamConfig, ctc_beam_search

    dev = _cuda()
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(4, 120, 60, generator=g) * 3.0
    lp = torch.log_softmax(logits, dim=-1)
    lens = torch.tensor([120, 97, 40, 1])
    cfg = CTCBeamConfig(beam_size=10, beam_size_token=16)
    ref = ctc_beam_search(lp, lens, cfg)
    got = ctc_beam_search(lp.to(dev), lens.to(dev), cfg)
    assert got[0].is_cuda
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    torch.testing.assert_close(got[2].cpu(), ref[2], rtol=0, atol=1e-3)


# ---- the serving profile (kernels/layer.py::PROFILES) and the log-mel kernel's
# bf16 and high DFT modes (csrc/mel_bf16.cu): each against its plain version.


@pytest.mark.parametrize("mode", ["bf16", "high"])
@pytest.mark.parametrize("B,S", [(1, 16000 * 2 + 3), (3, 16000 * 3 + 1), (8, 160000 + 2), (8, 160000),
                                 (128, 160000), (2, 2000)])
@pytest.mark.parametrize("quiet", [False, True])
def test_mel_bf16_modes_against_plain(mode, B, S, quiet):
    """The tensor-core DFT in "bf16" and "high" on speech-like input and on
    the same input x 1e-4, at S that are and are no multiple of 4: the same
    bf16 operands as the plain version, fp32 sums in another order, so the
    log-mel within 1e-3 of its scale; counted under its mode's name. B=8 x 10 s
    takes the one-warpgroup blocks (64 frames), B=128 x 10 s the two-warpgroup
    ones (128 frames); 998 frames leave a ragged last tile in both, and S =
    2,000 (11 frames) is shorter than one tile."""
    dev = _cuda()
    cfg = LogMelConfig(matmul_precision=mode)
    wav = torch.from_numpy(_speech_batch(B, S, seed=B) * (1e-4 if quiet else 1.0)).to(dev)
    fe = K3.MelFrontEnd(cfg, device=dev)
    n_frames = int(cfg.num_frames(S))
    args = (n_frames, fe.dft, fe.mel, cfg.hop_length, cfg.mel_floor, mode)
    _build.reset_launch_counts()
    got = K3.log_mel(wav, *args)
    assert dict(_build.LAUNCHES) == {f"asr_log_mel_{mode}": 1} and got.shape == (B, n_frames, cfg.num_mel_bins)
    _close(got, K3.log_mel_plain(wav, *args), 1e-3)


def test_mel_bf16_refuses_shapes_outside_its_contract():
    """The bf16 kernel's wrapper raises, and never falls back to the plain
    version, on bins not in passes of 64, more than MEL_MAX_BINS mel bins, a hop that is
    no multiple of 16, frames past S, and a bank whose filter has two runs: at 80 bins,
    and at 10 bins, a hole in a filter whose run spans three passes (the wide run
    itself is taken)."""
    dev = _cuda()
    cfg = LogMelConfig(matmul_precision="bf16")
    fe = K3.MelFrontEnd(cfg, device=dev)
    wav = torch.zeros(2, 16000, device=dev)
    n = int(cfg.num_frames(16000))
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="passes of 64"):
        K3.log_mel(wav, n, fe.dft[:, :480].contiguous(), fe.mel[:240].contiguous(), 160, 1e-10, "bf16")
    with pytest.raises(ValueError, match="at most MEL_MAX_BINS = 128"):
        K3.log_mel(wav, n, fe.dft, torch.zeros(256, 129, device=dev), 160, 1e-10, "bf16")
    with pytest.raises(ValueError, match="multiples of 16"):
        K3.log_mel(wav, n, fe.dft, fe.mel, 150, 1e-10, "bf16")
    with pytest.raises(ValueError, match="frames need more"):
        K3.log_mel(wav, n + 1, fe.dft, fe.mel, 160, 1e-10, "bf16")
    split = fe.mel.clone()
    split[200, 10] = 0.5
    with pytest.raises(ValueError, match="filter 10"):
        K3.log_mel(wav, n, fe.dft, split, 160, 1e-10, "bf16")
    narrow = K3.MelFrontEnd(LogMelConfig(num_mel_bins=10, matmul_precision="bf16"), device=dev)
    holed = narrow.mel.clone()
    nz = torch.nonzero(holed[:, 8]).flatten()
    assert int(nz[-1]) // 64 - int(nz[0]) // 64 >= 2  # the run spans three passes
    holed[int(nz[len(nz) // 2]), 8] = 0.0
    with pytest.raises(ValueError, match="filter 8 has nonzero"):
        K3.log_mel(wav, n, narrow.dft, holed, 160, 1e-10, "bf16")
    assert sum(_build.LAUNCHES.values()) == 0


def _every_bf16_value(finite: bool = False) -> torch.Tensor:
    values = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return values[torch.isfinite(values.float())] if finite else values


def _serving_gelu_ref(x: torch.Tensor) -> torch.Tensor:
    """``act_plain("gelu_serving")`` of the kernels' fp32 value, rounded to
    bf16. A product's sum turns -0 into +0, so the reference takes x + 0."""
    return K1.act_plain("gelu_serving", x.float() + 0.0).bfloat16()


def _bit_equal(got: torch.Tensor, ref: torch.Tensor) -> None:
    nan = torch.isnan(ref.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(torch.where(nan, 0, got.view(torch.int16)), torch.where(nan, 0, ref.view(torch.int16)))


@pytest.mark.parametrize("tile", ["large", "small"])
def test_gemm_gelu_serving_on_every_bf16_value(tile):
    """``gelu_serving8`` in the GEMM epilogue: rows whose product is each of
    the 65,536 bf16 values exactly (a one in the weight's first row, the value
    in the row's first column, zeros elsewhere; no bias), so that every output
    column is the serving GELU of that value: bit-equal to
    ``act_plain("gelu_serving")`` on every input, NaNs in place. "large" runs
    the 128 x 128 persistent tile (M = 65,536 in one launch), "small" the
    64 x 64 one (four launches of M = 16,384, fewer tiles than SMs)."""
    dev = _cuda()
    K, N = 64, 128
    values = _every_bf16_value().to(dev)
    w = torch.zeros(K, N, dtype=torch.bfloat16, device=dev)
    w[0] = 1.0
    parts = [values] if tile == "large" else list(values.split(16384))
    _build.reset_launch_counts()
    for part in parts:
        a = torch.zeros(part.numel(), K, dtype=torch.bfloat16, device=dev)
        a[:, 0] = part
        got = K1.gemm(a, w, None, act="gelu_serving")
        _bit_equal(got, _serving_gelu_ref(part)[:, None].expand(-1, N))
    assert dict(_build.LAUNCHES) == {"asr_gemm_gelu_serving": len(parts)}


def test_conv2_serving_gelu_on_every_finite_bf16_value():
    """``gelu_serving8`` in conv2's serving epilogue: the weight is one at the
    centre tap from each channel to itself and zero elsewhere, the bias zero,
    and conv1's output holds every finite bf16 value once at the centre taps'
    places (channel fastest) and zeros between them, so that output (t2, f2,
    c) is the serving GELU of one value: bit-equal to
    ``act_plain("gelu_serving")`` of it. Infinities and NaNs are left out: a
    zero weight times an infinity at a neighbour's tap is a NaN in the kernel
    and in the plain conv alike."""
    dev = _cuda()
    C, T2, F2 = 256, 16, 20
    values = _every_bf16_value(finite=True)
    grid = torch.zeros(T2 * F2 * C, dtype=torch.bfloat16)
    grid[:values.numel()] = values
    y1 = torch.zeros(1, 2 * T2, 2 * F2, C, dtype=torch.bfloat16)
    y1[0, 0::2, 0::2] = grid.view(T2, F2, C)
    w2 = torch.zeros(9 * C, C, dtype=torch.bfloat16)
    w2[4 * C:5 * C] = torch.eye(C, dtype=torch.bfloat16)
    _build.reset_launch_counts()
    got = K2.conv2(y1.to(dev), w2.to(dev), torch.zeros(C, device=dev), T2, "serving")
    assert dict(_build.LAUNCHES) == {"asr_conv2_serving": 1}
    _bit_equal(got.view(-1), _serving_gelu_ref(grid.to(dev)))


def test_serving_gemm_epilogue_against_plain(fused):
    """The serving GELU in the GEMM epilogue, both tile shapes (M = 120 and
    32,768), counted as ``asr_gemm_gelu_serving``; the gate epilogue takes the
    code too."""
    dev = _cuda()
    _, fm = fused
    w = fm.layers[0]
    g = torch.Generator().manual_seed(11)
    for M in (120, 32768):
        a = torch.randn(M, CFG.hidden_size, generator=g).bfloat16().to(dev)
        _build.reset_launch_counts()
        got = K1.gemm(a, w["ff1_wi"], w["ff1_bi"], act="gelu_serving")
        assert dict(_build.LAUNCHES) == {"asr_gemm_gelu_serving": 1}
        _close(got, K1.gemm_plain(a, w["ff1_wi"], w["ff1_bi"], act="gelu_serving"), 2 ** -6)
    C = w["ff1_wi"].shape[1]
    gate = torch.randn(120, C, generator=g).bfloat16().to(dev)
    a = torch.randn(120, C, generator=g).bfloat16().to(dev)
    wl = (torch.randn(C, C, generator=g) * C ** -0.5).bfloat16().to(dev)
    _close(K1.gemm(a, wl, None, act="gelu_serving", gate=gate),
           K1.gemm_plain(a, wl, None, act="gelu_serving", gate=gate), 2 ** -6)


@pytest.mark.parametrize("T", [40, 256, 504])
@pytest.mark.parametrize("width", ["32", "44->64", "64, q_rot 512"])
def test_rel_attention_serving_against_plain(T, width):
    """The serving normaliser at the head widths and q_rot widths the route
    takes (the k_std chunk ring past 256), lengths with 0 and 1, on column
    views of one projection buffer: within 2^-6 of the scale."""
    dev = _cuda()
    H, hw, D = {"32": (8, 32, 256), "44->64": (4, 64, 192), "64, q_rot 512": (8, 64, 512)}[width]
    B = 4
    g = torch.Generator().manual_seed(T + D)
    qkv = torch.randn(B * T, 3 * H * hw, generator=g).bfloat16().to(dev)
    q_u, k, v = (qkv[:, i * H * hw:(i + 1) * H * hw].view(B, T, H, hw) for i in range(3))
    q_rot = (torch.randn(B, T, H, D, generator=g) * 0.25).bfloat16().to(dev)
    k_std = torch.randn(T, D, generator=g).bfloat16().to(dev)
    lens = torch.tensor([T, 1, 0, T // 2], dtype=torch.int32, device=dev)
    args = (q_u, k, v, q_rot, k_std, lens)
    _build.reset_launch_counts()
    got = K1.rel_attention(*args, profile="serving")
    assert dict(_build.LAUNCHES) == {"asr_rel_attention_serving": 1}
    _close(got, K1.rel_attention_plain(*args, profile="serving"), 2 ** -6)


@pytest.mark.parametrize("bias", ["zero", "seeded"])
def test_conv1_serving_gelu_on_every_bf16_value(bias):
    """``test_conv1_gelu_on_every_bf16_value`` under the serving profile: the
    block's table of ``gelu_serving`` and its fallback equal the plain
    version's expression (``act_plain("gelu_serving")`` of the bf16 sum,
    rounded to bf16) bit for bit on every bf16 input, NaNs in place."""
    dev = _cuda()
    T1, F1 = 1639, 40
    values = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    grid = torch.zeros(T1 * F1, dtype=torch.bfloat16)
    grid[:65536] = values
    feats = torch.zeros(1, 2 * T1 - 1, 2 * F1, dtype=torch.bfloat16)
    feats[0, 0::2, 0::2] = grid.view(T1, F1)
    w1 = torch.zeros(9, 256, dtype=torch.bfloat16, device=dev)
    w1[4] = 1.0
    b1 = torch.zeros(256)
    if bias == "seeded":
        g = torch.Generator().manual_seed(7)
        b1 = torch.randn(256, generator=g).sign() * 2.0 ** torch.randint(-30, 7, (256,), generator=g)
        b1 = (b1 * (1.0 + torch.rand(256, generator=g))).bfloat16().float()
    b1 = b1.to(dev)
    _build.reset_launch_counts()
    got = K2.conv1(feats.to(dev), w1, b1, "serving").float()
    assert dict(_build.LAUNCHES) == {"asr_conv1_serving": 1}
    x = grid.float().to(dev).view(1, T1, F1, 1)
    ref = K1.act_plain("gelu_serving", (x + b1).bfloat16().float()).bfloat16().float()
    nan = torch.isnan(ref)
    assert int(nan.sum()) > 0 and torch.equal(torch.isnan(got), nan)
    assert torch.equal(torch.where(nan, 0.0, got), torch.where(nan, 0.0, ref))


def test_ctc_infer_serving_launches_kernels_and_matches_plain(fused):
    """``FusedCTC(..., profile="serving")``: the serving pieces launch (and no
    exact conv1, conv2 or attention; the GELU GEMMs all take the LayerNorm
    prologue, the QKV and the subsampler's projection too, and one
    LayerNorm a layer is left), the logits within 0.05 of the plain serving
    path's."""
    dev = _cuda()
    model, _ = fused
    fm = FusedCTC(model, "cuda", profile="serving")
    feats = torch.randn(3, 150, 80, generator=torch.Generator().manual_seed(3)).to(dev)
    lens = torch.tensor([150, 96, 41], dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    got = ctc_infer(fm, feats, lens)
    torch.cuda.synchronize()
    n = CFG.num_hidden_layers
    want = {"asr_conv1_serving": 1, "asr_conv2_serving": 1, "asr_rel_attention_serving": n,
            "asr_gemm_ln_gelu_serving": 3 * n, "asr_gemm_ln_bf16": n + 1, "asr_layernorm_bf16": n}
    assert {k: _build.LAUNCHES[k] for k in want} == want
    assert not {"asr_conv1", "asr_conv2", "asr_rel_attention"} & set(_build.LAUNCHES)
    ref = ctc_infer(fm, feats, lens, plain=True)
    assert torch.equal(got.logit_lengths, ref.logit_lengths)
    _close(got.logits, ref.logits, 0.05)


# ---- the GEMM with a LayerNorm prologue (csrc/gemm_ln.cu): at the five call
# sites' epilogues and the shipped configs' widths, both tile shapes (M = 56
# and 2,048 in the small one, 32,768 in the large one), bit-equal to the
# two-launch chain it replaces (layer_norm, then gemm), and within the GEMM's
# tolerance of its plain version.

LN_GEMM_SITES = {  # (N for a hidden size D, the call's epilogue): the macaron FFs' and cgMLP's
    "ff_in (+gelu)": (lambda D: 4 * D, dict(act="gelu")),  # intermediate dense, channel_proj1
    "ff_in (+serving gelu)": (lambda D: 4 * D, dict(act="gelu_serving")),
    "qkv (dual)": (lambda D: 3 * D, dict()),  # bias2: q_v
    "proj (round_first)": (lambda D: D, dict(round_first=True)),  # the subsampler's projection
}


@pytest.mark.parametrize("site", list(LN_GEMM_SITES))
@pytest.mark.parametrize("D", [176, 256, 512])
@pytest.mark.parametrize("M", [56, 2048, 32768])
def test_ln_gemm_bit_equal_to_layernorm_then_gemm(site, D, M):
    """One launch, counted under its label; every output (both of the QKV
    call) bit-equal to ``layer_norm`` then ``gemm``, within 2^-6 of
    ``ln_gemm_plain``. The rows are a view into a wider buffer and include a
    zero row (its operand is b)."""
    dev = _cuda()
    g = torch.Generator().manual_seed(D + M)
    n_of, kw = LN_GEMM_SITES[site]
    N = n_of(D)
    x = (torch.randn(M, D + 16, generator=g) * 2.0 + 0.3).bfloat16().to(dev)[:, 8:D + 8]
    x[M // 3] = 0.0
    gamma, beta = (1.0 + 0.1 * torch.randn(D, generator=g)).to(dev), (0.1 * torch.randn(D, generator=g)).to(dev)
    w = (torch.randn(D, N, generator=g) * D ** -0.5).bfloat16().to(dev)
    bias = K1._round(0.1 * torch.randn(N, generator=g)).to(dev)
    if site == "qkv (dual)":
        kw = dict(bias2=K1._round(0.1 * torch.randn(D, generator=g)).to(dev))
    _build.reset_launch_counts()
    got = K1.ln_gemm(x, gamma, beta, 1e-5, w, bias, **kw)
    label = "asr_gemm_ln_gelu_serving" if kw.get("act") == "gelu_serving" else "asr_gemm_ln_bf16"
    assert dict(_build.LAUNCHES) == {label: 1}
    chain = K1.gemm(K1.layer_norm(x, gamma, beta, 1e-5), w, bias, **kw)
    ref = K1.ln_gemm_plain(x, gamma, beta, 1e-5, w, bias, **kw)
    for got_i, chain_i, ref_i in (zip(got, chain, ref) if "bias2" in kw else [(got, chain, ref)]):
        _bit_equal(got_i, chain_i)
        _close(got_i, ref_i, 2 ** -6)


@pytest.mark.parametrize("M,D,N", [(2112, 256, 1024), (8200, 256, 768), (8200, 176, 704), (32768, 256, 128),
                                   (32768, 512, 1536)])
def test_ln_gemm_large_tile_schedules(M, D, N):
    """The large tile's schedules: a row tile's column tiles split into runs
    over several blocks (M = 2,112 and 8,200, a ragged last row tile), one
    column tile a row tile (one team idle in every other unit), one A buffer
    at K = 512; bit-equal to layer_norm then gemm."""
    dev = _cuda()
    g = torch.Generator().manual_seed(M + N)
    x = (torch.randn(M, D, generator=g) * 2.0 + 0.3).bfloat16().to(dev)
    gamma, beta = (1.0 + 0.1 * torch.randn(D, generator=g)).to(dev), (0.1 * torch.randn(D, generator=g)).to(dev)
    w = (torch.randn(D, N, generator=g) * D ** -0.5).bfloat16().to(dev)
    bias = K1._round(0.1 * torch.randn(N, generator=g)).to(dev)
    got = K1.ln_gemm(x, gamma, beta, 1e-5, w, bias, act="gelu")
    _bit_equal(got, K1.gemm(K1.layer_norm(x, gamma, beta, 1e-5), w, bias, act="gelu"))


def test_ln_gemm_into_a_column_slice_and_its_contract():
    """``out`` as a column slice of a wider buffer (the other columns and the
    rows past M untouched); what the kernel does not take raises before any
    launch: K % 8, K past 512, g of the wrong length or type."""
    dev = _cuda()
    g = torch.Generator().manual_seed(5)
    M, D, N = 120, 256, 256
    x = torch.randn(M, D, generator=g).bfloat16().to(dev)
    gamma, beta = (1.0 + 0.1 * torch.randn(D, generator=g)).to(dev), (0.1 * torch.randn(D, generator=g)).to(dev)
    w = (torch.randn(D, N, generator=g) * D ** -0.5).bfloat16().to(dev)
    guard = torch.full((M + 8, N + 32), 7.0, dtype=torch.bfloat16, device=dev)
    K1.ln_gemm(x, gamma, beta, 1e-5, w, None, out=guard[:M, 16:16 + N])
    _bit_equal(guard[:M, 16:16 + N], K1.gemm(K1.layer_norm(x, gamma, beta, 1e-5), w))
    assert bool((guard[:, :16] == 7.0).all() and (guard[:, 16 + N:] == 7.0).all() and (guard[M:] == 7.0).all())
    _build.reset_launch_counts()
    wide = torch.zeros(M, 520, dtype=torch.bfloat16, device=dev)
    for bad in (dict(x=x[:, :D - 4], gamma=gamma[:D - 4], beta=beta[:D - 4], w=w[:D - 4]),
                dict(x=wide, gamma=wide[0].float(), beta=wide[0].float(),
                     w=torch.zeros(520, 64, dtype=torch.bfloat16, device=dev)),
                dict(x=x, gamma=gamma[:D - 8], beta=beta, w=w),
                dict(x=x, gamma=gamma.double(), beta=beta, w=w)):
        with pytest.raises(ValueError):
            K1.ln_gemm(bad["x"], bad["gamma"], bad["beta"], 1e-5, bad["w"])
    assert not _build.LAUNCHES
