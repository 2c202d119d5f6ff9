"""PyTorch port, the serving numeric profile's pieces and route against the
JAX package's: K3's DFT modes against fp64, K1's layer and K2 in
``profile="serving"``, and the whole CTC route in that profile, each against
the JAX function in the same mode (interpret mode, the profile set and
restored in a ``finally``) with the tolerance it states.

Split from ``tests/test_torch_serving_profile.py`` (whose helpers and shapes
these tests share) so that the two files run on two workers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.models.fast_infer import ctc_infer_fused
from huggingface_asr_tpu.ops import pallas_layer as PL
from huggingface_asr_tpu.ops.features import LogMelConfig as JLogMelConfig
from huggingface_asr_tpu.ops.pallas_features import PallasLogMelFrontEnd
from huggingface_asr_tpu.ops.pallas_subsample import conv_subsample_fused
from test_torch_serving_profile import _jax_serving, _np
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels import layer as K1
from huggingface_asr_tpu_torch.kernels import mel as K3
from huggingface_asr_tpu_torch.kernels import subsample as K2
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer
from huggingface_asr_tpu_torch.ops.features import LogMelConfig

B, T, T_VALID = 4, 24, 21
LENS = np.asarray([21, 17, 9, 0], np.int32)


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
