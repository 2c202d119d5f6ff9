"""PyTorch port, the serving numeric profile against the JAX package's.

The JAX serving path (``huggingface_asr_tpu/serving/pipeline.py:86-113``)
sets ``set_numeric_profile("serving")`` and runs the log-mel kernel with
``matmul_precision="bf16"`` and the fused CMVN. The port's counterparts are
arguments: ``MelFrontEnd(LogMelConfig(matmul_precision=...))`` and the
``profile`` of K2, K1 and ``FusedCTC``. Each test feeds the same
numpy-seeded inputs to the JAX function in the same mode (interpret mode,
the profile set and restored to "bitexact" in a ``finally``) and to the
port's plain versions, with the tolerance it states.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.fast_infer import ctc_infer_fused
from huggingface_asr_tpu.ops import pallas_layer as PL
from huggingface_asr_tpu.ops.features import LogMelConfig as JLogMelConfig
from huggingface_asr_tpu.ops.pallas_features import PallasLogMelFrontEnd
from huggingface_asr_tpu.ops.pallas_subsample import conv_subsample_fused
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels import layer as K1
from huggingface_asr_tpu_torch.kernels import mel as K3
from huggingface_asr_tpu_torch.kernels import subsample as K2
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer
from huggingface_asr_tpu_torch.ops.features import LogMelConfig

B, T, T_VALID = 4, 24, 21
LENS = np.asarray([21, 17, 9, 0], np.int32)


def _np(a):
    return np.asarray(a, np.float32)


def _jax_serving(fn):
    """``fn()`` under the JAX package's serving profile, restored after."""
    PL.set_numeric_profile("serving")
    try:
        return fn()
    finally:
        PL.set_numeric_profile("bitexact")


def _bf16_order(x: np.ndarray) -> np.ndarray:
    """bf16 values (held in fp32) as integers in the order of the values, one
    apart per bf16 ulp (sign-magnitude bits folded onto a line)."""
    b = (x.view(np.uint32) >> 16).astype(np.int64)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def test_serving_gelu_on_every_finite_bf16_value():
    """``act_plain("gelu_serving")`` rounded to bf16 against JAX's
    ``_gelu_fastest`` on all 65,280 finite bf16 values: within one bf16 ulp.
    The port computes the TPU's approximate reciprocal with its Newton step
    as an IEEE reciprocal (one fp32 ulp apart before the rounding). XLA's CPU
    backend flushes subnormal inputs and results to zero and the port does
    not: where JAX's input is subnormal or its result was flushed to zero
    (|x| <= 2^-125), the port's result is at most the smallest normal fp32
    (2^-126) in magnitude instead."""
    v = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    v = v[np.isfinite(v)]
    ref = _np(_jax_serving(lambda: jax.jit(PL._gelu_fastest)(jnp.asarray(v, jnp.bfloat16))))
    got = K1.act_plain("gelu_serving", torch.from_numpy(v)).to(torch.bfloat16).float().numpy()
    tiny = np.float32(2.0 ** -126)
    flushed = (np.abs(v) < tiny) | ((ref == 0) & (got != 0) & (np.abs(v) <= 2 * tiny))
    ulps = np.abs(_bf16_order(got) - _bf16_order(ref))
    assert ulps[~flushed].max() <= 1, ulps[~flushed].max()
    assert np.all(np.abs(got[flushed]) <= tiny)
    assert np.mean(got == ref) > 0.99


def test_serving_gelu_is_the_exact_gelu_within_bf16_resolution():
    """A&S 7.1.27 (|erfc error| <= 5e-4) against the fp32 erfc GELU over
    [-12, 12]: within one bf16 ulp of the exact value plus 2.5e-4 |x|."""
    x = torch.linspace(-12.0, 12.0, 20001).to(torch.bfloat16).float()
    got = K1.act_plain("gelu_serving", x)
    ref = K1.act_plain("gelu", x)
    assert torch.all((got - ref).abs() <= 2.5e-4 * x.abs() + 2 ** -8 * ref.abs() + 1e-7)


def test_profiles_are_arguments_and_refuse_other_names():
    assert K1.profile_act("gelu", "serving") == "gelu_serving"
    assert K1.profile_act("gelu", "exact") == "gelu"
    assert K1.profile_act("swish", "serving") == "swish"  # only the model's GELUs change
    with pytest.raises(ValueError, match="numeric profile"):
        K1.profile_act("gelu", "bitexact")
    with pytest.raises(ValueError, match="matmul_precision"):
        K3.MelFrontEnd(LogMelConfig(matmul_precision="fastest"), device="cpu")


@pytest.mark.parametrize("mode", ["bf16", "high"])
def test_log_mel_mode_matches_pallas_interpret(mode):
    """The port's ``MelFrontEnd`` (plain versions) against
    ``PallasLogMelFrontEnd(..., interpret=True, fused_cmvn_bf16=True)`` in the
    same DFT mode, B=2 with ragged lengths: the same bf16 operands and band
    order, fp32 sums in another order, then CMVN and one bf16 rounding. Every
    feature within one bf16 ulp at the features' scale (2^-7 of it), 99 % bit
    for bit, the frame lengths equal."""
    rng = np.random.default_rng(7)
    S = 16000 * 2
    lens = np.asarray([S, S - 5123], np.int32)
    wav = (0.1 * rng.standard_normal((2, S))).astype(np.float32)
    wav[1, lens[1]:] = 0.0
    j_feats, j_lens = PallasLogMelFrontEnd(JLogMelConfig(matmul_precision=mode), interpret=True,
                                           fused_cmvn_bf16=True)(jnp.asarray(wav), jnp.asarray(lens))
    front = K3.MelFrontEnd(LogMelConfig(matmul_precision=mode), device="cpu")
    assert front.mode == mode and front.dft.dtype == torch.bfloat16
    assert tuple(front.dft.shape) == ((2 if mode == "high" else 1), 512, 400)
    feats, feat_lens = front(torch.from_numpy(wav), torch.from_numpy(lens))
    got, ref = feats.float().numpy(), _np(j_feats)[:, :feats.shape[1]]
    np.testing.assert_array_equal(feat_lens.numpy(), np.asarray(j_lens))
    d = np.abs(got - ref)
    assert d.max() <= 2 ** -7 * max(1.0, np.abs(ref).max()), d.max()
    assert np.mean(d == 0) > 0.99, np.mean(d == 0)


def test_log_mel_bf16_modes_against_fp64():
    """Before CMVN, against the folded product in fp64: "high" keeps the fp32
    contract's accuracy (within 1e-3 of the log-mel), "bf16" is the coarse
    single pass (within 0.25, 0.12 on this input; its mean error below 0.01)."""
    rng = np.random.default_rng(8)
    wav = torch.from_numpy((0.1 * rng.standard_normal((2, 16000))).astype(np.float32))
    cfg = LogMelConfig()
    n = int(cfg.num_frames(16000))
    dft, mel = (torch.from_numpy(a) for a in K3.folded_bases(cfg))
    exact = K3.log_mel_plain(wav.double(), n, dft.double(), mel.double(), cfg.hop_length, cfg.mel_floor)
    for mode, worst, mean in (("high", 1e-3, 1e-4), ("bf16", 0.25, 0.01)):
        bases = K3.split_bases(dft.numpy(), mode)
        d = (K3.log_mel_plain(wav, n, bases, mel, cfg.hop_length, cfg.mel_floor, mode).double() - exact).abs()
        assert d.max() <= worst and d.mean() <= mean, (mode, float(d.max()), float(d.mean()))


@pytest.mark.parametrize("csgu_linear", [False, True])
def test_serving_layer_matches_pallas_interpret(csgu_linear):
    """One layer in ``profile="serving"`` against ``ebranchformer_layer(...,
    interpret=True)`` under JAX's serving profile, with the CSGU linear off
    and on. Tolerance as ``tests/test_torch_layer.py`` holds "exact" to
    "bitexact": 2^-6 of the output scale, a mean below 2^-7 (fp32 sums in
    another order flip isolated bf16 ulps)."""
    jcfg, pcfg, tree, _, pmodel = make_models(seed=0, csgu_use_linear_after_conv=csgu_linear)
    lp = tree["wav2vec2"]["encoder"]["layers_0"]
    x = np.random.default_rng(1).standard_normal((B, T, jcfg.hidden_size)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    ref = _np(_jax_serving(lambda: PL.ebranchformer_layer(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(LENS), PL.fold_layer_weights(lp, jcfg, T), jcfg, bb=2,
        t_valid=T_VALID, interpret=True)))
    w = K1.fold_layer_weights(pmodel.wav2vec2.encoder.layers[0], pcfg)
    tables = K1.relpos_kernel_tables(T, jcfg.hidden_size)
    got = K1.ebranchformer_layer(torch.from_numpy(x).bfloat16(), torch.from_numpy(LENS), w, pcfg, T_VALID, tables,
                                 profile="serving").float().numpy()
    exact = K1.ebranchformer_layer(torch.from_numpy(x).bfloat16(), torch.from_numpy(LENS), w, pcfg, T_VALID,
                                   tables).float().numpy()
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    assert d.max() <= 2 ** -6 * max(1.0, np.abs(ref).max()), d.max()
    assert d.mean() <= 2 ** -7, d.mean()
    assert not np.array_equal(got, exact)  # the profile reached the pieces


def test_serving_subsample_matches_pallas_interpret():
    """K2 in ``profile="serving"`` against ``conv_subsample_fused(...,
    interpret=True)`` under JAX's serving profile (its GELU is
    ``pallas_layer.gelu_bf16``, pallas_subsample.py:65-68): tolerance 6e-2,
    as ``tests/test_torch_subsample.py`` holds the exact profile."""
    jcfg, pcfg, tree, _, pmodel = make_models(seed=3, hidden_size=256, num_hidden_layers=1)
    w = K2.fold_subsample_weights(pmodel.wav2vec2, pcfg)
    t_in = 100
    feats = np.random.default_rng(0).standard_normal((2, t_in, 80)).astype(np.float32)
    T2 = ((t_in - 1) // 2) // 2 + 1
    T2_pad = -(-T2 // 8) * 8
    ref = _np(_jax_serving(lambda: conv_subsample_fused(tree["wav2vec2"], jcfg, jnp.asarray(feats), T2_pad=T2_pad,
                                                        interpret=True)))[:, :T2]
    got = K2.conv_subsample(torch.from_numpy(feats), w, pcfg, T2_pad, "serving").float().numpy()[:, :T2]
    np.testing.assert_allclose(got, ref, rtol=0, atol=6e-2)
    y1 = K2.conv1_plain(torch.from_numpy(feats).bfloat16(), w["w1"], w["b1"], "serving")
    assert not torch.equal(y1, K2.conv1_plain(torch.from_numpy(feats).bfloat16(), w["w1"], w["b1"]))


def test_serving_route_matches_the_jax_serving_composition():
    """The whole CTC route in the serving profile (2 layers x 128, the K2 front
    end), waveform to logits: the port's bf16-DFT ``MelFrontEnd`` and
    ``ctc_infer`` on ``FusedCTC(..., profile="serving")`` against JAX's
    ``PallasLogMelFrontEnd(bf16, interpret, fused CMVN)`` and
    ``ctc_infer_fused(interpret=True)`` under its serving profile: logits
    within 0.05 of their scale, as ``tests/test_pallas_layer.py:117-120``
    bounds JAX's own modes against "bitexact". No kernel launches on the CPU."""
    jcfg, pcfg, tree, _, pmodel = make_models(seed=5)
    rng = np.random.default_rng(9)
    S = 16000
    lens = np.asarray([S, 11000], np.int32)
    wav = (0.1 * rng.standard_normal((2, S))).astype(np.float32)
    wav[1, lens[1]:] = 0.0

    def jax_route():
        front = PallasLogMelFrontEnd(JLogMelConfig(matmul_precision="bf16"), interpret=True, fused_cmvn_bf16=True)
        feats, feat_lens = front(jnp.asarray(wav), jnp.asarray(lens))
        return ctc_infer_fused(tree, jcfg, feats, feat_lens, bb=2, interpret=True)

    ref = _jax_serving(jax_route)
    fused = FusedCTC(pmodel, "cpu", profile="serving")
    front = K3.MelFrontEnd(LogMelConfig(matmul_precision="bf16"), device="cpu")
    _build.reset_launch_counts()
    with torch.no_grad():
        out = ctc_infer(fused, *front(torch.from_numpy(wav), torch.from_numpy(lens)))
    assert sum(_build.LAUNCHES.values()) == 0
    np.testing.assert_array_equal(out.logit_lengths.numpy(), np.asarray(ref.logit_lengths))
    g, r = out.logits.float().numpy(), _np(ref.logits)
    valid = np.arange(r.shape[1])[None, :] < np.asarray(ref.logit_lengths)[:, None]
    d = np.abs(g - r)[valid]
    assert np.isfinite(g[valid]).all()
    assert d.max() <= 0.05 * max(1.0, np.abs(r[valid]).max()), d.max()
