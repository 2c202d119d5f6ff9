"""PyTorch port, log-mel front end (K3) vs the JAX package.

The same seeded numpy waveforms go through the JAX front ends and the port's.
The Pallas kernel runs in interpret mode, as tests/test_pallas_features.py
runs it; the port's wrappers run their plain versions on CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.ops.features import LogMelConfig as JLogMelConfig
from huggingface_asr_tpu.ops.features import LogMelFrontEnd as JLogMelFrontEnd
from huggingface_asr_tpu.ops.pallas_features import PallasLogMelFrontEnd
from huggingface_asr_tpu.ops.pallas_features import folded_bases as j_folded_bases
from huggingface_asr_tpu_torch.data.synthetic_speech import utterance
from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels import mel as K3
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd


def _wave(seed, B=2, S=16000 * 2, cut=5000):
    rng = np.random.default_rng(seed)
    wav = rng.standard_normal((B, S)).astype(np.float32) * 0.1
    lens = np.asarray([S] + [S - cut * (i + 1) for i in range(B - 1)], np.int32)
    return wav, lens


def test_folded_bases_equal_jax():
    dft, mel = K3.folded_bases(LogMelConfig())
    j_dft, j_mel = j_folded_bases(JLogMelConfig())
    np.testing.assert_array_equal(dft, j_dft)
    np.testing.assert_array_equal(mel, j_mel)


@pytest.mark.parametrize("quiet", [False, True])
def test_plain_log_mel_matches_pallas_interpret(quiet):
    """The plain log-mel on the folded bases (what a CPU tensor runs, and
    what the kernel is held to on the card) against the Pallas kernel at the
    'highest' contract in interpret mode, without CMVN, on seeded synthetic
    speech and on the same x 1e-4 (bins near the mel floor): the same bases,
    the products summed in another order."""
    rng = np.random.default_rng(5)
    S = 16000 * 2
    wav = np.zeros((2, S), np.float32)
    for i, n in enumerate((S, S - 7000)):
        w = utterance(n / 16000, rng)[0][:n]
        wav[i, :len(w)] = w
    if quiet:
        wav *= np.float32(1e-4)
    jcfg = JLogMelConfig(norm_type="none", matmul_precision="highest")
    ref, _ = PallasLogMelFrontEnd(jcfg, interpret=True)(jnp.asarray(wav), jnp.full((2,), S, jnp.int32))
    cfg = LogMelConfig()
    fe = K3.MelFrontEnd(cfg)
    n_frames = int(cfg.num_frames(S))
    got = K3.log_mel_plain(torch.from_numpy(wav), n_frames, fe.dft, fe.mel, cfg.hop_length, cfg.mel_floor)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_fused_cmvn_bf16_matches_pallas_interpret():
    """Plain K3 (folded DFT, fused CMVN, bf16) vs the Pallas kernel at the
    'highest' contract. Tolerance 2e-2 as tests/test_pallas_features.py:86:
    one bf16 rounding of CMVN'd values of magnitude up to ~4."""
    wav, lens = _wave(3)
    j_fe = PallasLogMelFrontEnd(JLogMelConfig(matmul_precision="highest"), interpret=True,
                                fused_cmvn_bf16=True)
    f_ref, l_ref = j_fe(jnp.asarray(wav), jnp.asarray(lens))
    f_got, l_got = K3.MelFrontEnd(LogMelConfig())(torch.from_numpy(wav), torch.from_numpy(lens))
    assert f_got.dtype == torch.bfloat16
    np.testing.assert_array_equal(l_got.numpy(), np.asarray(l_ref))
    g = f_got.float().numpy()
    np.testing.assert_allclose(g, np.asarray(f_ref, np.float32), rtol=0, atol=2e-2)
    n1 = int(l_got[1])
    assert np.all(g[1, n1:] == 0.0)


@pytest.mark.parametrize("norm_type", ["utterance", "global", "none"])
def test_plain_front_end_matches_jax_fp32(norm_type):
    """Plain fp32 LogMelFrontEnd vs JAX LogMelFrontEnd (highest precision):
    the same float64-built bases, fp32 products summed in another order."""
    wav, lens = _wave(0)
    stats = {}
    if norm_type == "global":
        rng = np.random.default_rng(4)
        stats = dict(global_means=rng.uniform(5.0, 15.0, 80).astype(np.float32),
                     global_stds=rng.uniform(2.0, 4.0, 80).astype(np.float32))
    f_ref, l_ref = JLogMelFrontEnd(JLogMelConfig(norm_type=norm_type), **stats)(
        jnp.asarray(wav), jnp.asarray(lens))
    f_got, l_got = LogMelFrontEnd(LogMelConfig(norm_type=norm_type), **stats)(
        torch.from_numpy(wav), torch.from_numpy(lens))
    np.testing.assert_array_equal(l_got.numpy(), np.asarray(l_ref))
    np.testing.assert_allclose(f_got.numpy(), np.asarray(f_ref), rtol=2e-4, atol=2e-4)


def test_folded_plain_matches_unfolded_plain():
    """The folded form (what the kernel computes) equals the unfolded front
    end at fp32: the DC/pre-emphasis/window fold is exact in exact arithmetic."""
    wav, lens = _wave(1, B=3)
    w, l = torch.from_numpy(wav), torch.from_numpy(lens)
    cfg = LogMelConfig()
    f_ref, l_ref = LogMelFrontEnd(LogMelConfig(norm_type="none"))(w, l)
    fe = K3.MelFrontEnd(cfg)
    n_frames = f_ref.shape[1]
    f_got = K3.log_mel_plain(w, n_frames, fe.dft, fe.mel, cfg.hop_length, cfg.mel_floor)
    assert f_got.shape == f_ref.shape
    valid = (torch.arange(n_frames)[None, :] < l_ref[:, None])[..., None]
    np.testing.assert_allclose(torch.where(valid, f_got, 0.0).numpy(), f_ref.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_cpu_tensors_launch_nothing():
    _build.reset_launch_counts()
    wav, lens = _wave(2)
    K3.MelFrontEnd(LogMelConfig())(torch.from_numpy(wav), torch.from_numpy(lens))
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("norm_means,norm_vars", [(True, True), (True, False), (False, True), (False, False)])
def test_plain_cmvn_at_edge_lengths_matches_pallas_interpret(norm_means, norm_vars):
    """The plain CMVN (what the CUDA kernel is held to on the card) against the
    Pallas kernel's fused CMVN in interpret mode in each normalisation mode, at
    the lengths the kernel's cluster slices meet: 0, 1 and 2 frames, all
    frames but one and all of them. Non-finite values (the one-frame
    utterance's zero variance) sit in the same places with the same values;
    the rest within one bf16 rounding of values up to ~4 (2e-2, as above).
    Without mean normalisation the variance is mean(x^2) - mean^2, which for
    one or two frames cancels to (nearly) nothing: for one frame it is x^2 -
    x^2, whose last rounding each side decides (XLA's fused multiply-add
    leaves a residue of either sign, the plain version an exact zero), and
    both sides give a non-finite value or one of magnitude at least 2^10; for
    two frames the cancellation multiplies the rounding differences past one
    bf16 ulp. There those two utterances are checked only for that and for
    their zeros past the length, the others (values up to ~64, where the
    cancellation still doubles the rounding differences) within 2^-6 of
    their scale."""
    S = 16000
    n_frames = int(LogMelConfig().num_frames(S))
    lens = np.asarray([0, 400, 560, S - 160, S], np.int32)  # 0, 1, 2, n_frames - 1 and n_frames frames
    wav = np.random.default_rng(6).standard_normal((len(lens), S)).astype(np.float32) * 0.1
    cfg = dict(normalize_means=norm_means, normalize_vars=norm_vars)
    j_fe = PallasLogMelFrontEnd(JLogMelConfig(matmul_precision="highest", **cfg), interpret=True,
                                fused_cmvn_bf16=True)
    f_ref, l_ref = j_fe(jnp.asarray(wav), jnp.asarray(lens))
    f_got, l_got = K3.MelFrontEnd(LogMelConfig(**cfg))(torch.from_numpy(wav), torch.from_numpy(lens))
    np.testing.assert_array_equal(l_got.numpy(), [0, 1, 2, n_frames - 1, n_frames])
    np.testing.assert_array_equal(l_got.numpy(), np.asarray(l_ref))
    g, r = f_got.float().numpy(), np.asarray(f_ref, np.float32)
    if norm_vars and not norm_means:
        for side in (g[1, :1], r[1, :1]):
            with np.errstate(invalid="ignore"):
                assert np.all(~np.isfinite(side) | (np.abs(side) >= 2.0 ** 10))
        assert np.all(g[1:3, 2:] == 0.0) and np.all(g[2, :2] != 0.0)
        g, r, lens = g[[0, 3, 4]], r[[0, 3, 4]], lens[[0, 3, 4]]
    finite = np.isfinite(r)
    np.testing.assert_array_equal(np.isfinite(g), finite)
    np.testing.assert_array_equal(g[~finite], r[~finite])
    atol = 2 ** -6 * max(1.0, float(np.abs(r[finite]).max())) if norm_vars and not norm_means else 2e-2
    np.testing.assert_allclose(g[finite], r[finite], rtol=0, atol=atol)
    for i, n in enumerate(LogMelConfig().num_frames(lens).tolist()):
        assert np.all(g[i, max(n, 0):] == 0.0)


def test_128_bins_empty_filter_column_matches_jax_nan_and_all():
    """ROADMAP.md reference caveat (k): the 128-filter Kaldi bank has an
    all-zero filter (index 3), so its log-mel column is the constant
    log(mel_floor), and the utterance CMVN divides a rounding residue by its
    own square root. The column comes out all NaN (150 frames) or all -1
    (171 frames), depending on the length, and the port's plain front end
    writes what the JAX one writes; every other column agrees within the
    tolerance of ``test_plain_front_end_matches_jax_fp32``."""
    rng = np.random.default_rng(0)
    S = 160 * 170 + 400
    wav = (rng.standard_normal((2, S)) * 0.1).astype(np.float32)
    lens = np.asarray([160 * 149 + 400, S], np.int32)  # 150 and 171 frames
    ref, ref_lens = JLogMelFrontEnd(JLogMelConfig(num_mel_bins=128))(jnp.asarray(wav), jnp.asarray(lens))
    got, got_lens = LogMelFrontEnd(LogMelConfig(num_mel_bins=128))(torch.from_numpy(wav), torch.from_numpy(lens))
    ref, got = np.asarray(ref), got.numpy()
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    assert list(got_lens.numpy()) == [150, 171]
    assert np.isnan(ref[0, :150, 3]).all() and (ref[1, :, 3] == -1.0).all()
    np.testing.assert_array_equal(got[:, :, 3], ref[:, :, 3])
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4, equal_nan=True)
