"""PyTorch port, the log-mel front end (K3) at bin counts other than 80,
against the JAX package.

23 is Kaldi's ``compute-fbank-feats`` default (no multiple of 8), 128 the
front end of Whisper large-v3. The JAX package takes any count: its Pallas
kernel runs here in interpret mode (``PallasLogMelFrontEnd(...,
interpret=True)``, ``ctc_infer_fused(..., interpret=True)``), the port's
wrappers run their plain versions on CPU tensors, on the same numpy-seeded
waveforms.

Reference caveat (k) (ROADMAP.md): the 128-filter Kaldi bank's filter 3 has
no nonzero weight, so its log-mel column is the constant log(mel_floor) and
utterance CMVN divides a rounding residue by its own square root: the column
comes out all NaN or all -1 depending on the length. The lengths below give
both (150 frames: NaN; 171 and 200 frames: -1), and each test asserts what
each side writes there; a NaN column makes that utterance's logits
non-finite on both sides (the whole route, ``tests/test_torch_mel_bins_route.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.ops.features import LogMelConfig as JLogMelConfig
from huggingface_asr_tpu.ops.pallas_features import PallasLogMelFrontEnd

from huggingface_asr_tpu_torch.cli.evaluate import recipe_frontend_refusal
from huggingface_asr_tpu_torch.data.synthetic_speech import utterance
from huggingface_asr_tpu_torch.kernels import mel as K3
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.fast_infer import fused_encoder_refusal
from huggingface_asr_tpu_torch.ops.features import LogMelConfig

BINS = (23, 128)
EMPTY = {128: 3}  # the bank's all-zero filter at each count (none at 23)
S = 160 * 199 + 400  # 200 frames
LENS = np.asarray([160 * 149 + 400, 160 * 170 + 400, S], np.int32)  # 150, 171 and 200 frames
COL3 = ("nan", -1.0, -1.0)  # what the 128-bin CMVN writes in column 3 at those lengths


def _np(a):
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def noise():
    """Three seeded noise waveforms of 200 frames, zero past 150, 171, 200 frames."""
    wav = (0.1 * np.random.default_rng(11).standard_normal((3, S))).astype(np.float32)
    for i, n in enumerate(LENS):
        wav[i, n:] = 0.0
    return wav


def _others(n_mel):
    return [c for c in range(n_mel) if c != EMPTY.get(n_mel)]


def _check_empty_column(n_mel, got, ref, frames):
    """Column EMPTY[n_mel] below each length: what ``COL3`` says, on both sides."""
    if n_mel not in EMPTY:
        return
    c = EMPTY[n_mel]
    for i, (n, want) in enumerate(zip(frames, COL3)):
        for side in (ref[i, :n, c], got[i, :n, c]):
            assert np.isnan(side).all() if want == "nan" else (side == want).all(), (i, side[:4])


@pytest.mark.parametrize("quiet", [False, True])
@pytest.mark.parametrize("n_mel", BINS)
def test_plain_log_mel_matches_pallas_interpret(n_mel, quiet):
    """``log_mel_plain`` on the folded bases against ``_mel_kernel`` at the
    "highest" contract in interpret mode, no CMVN, on seeded synthetic speech
    and on the same x 1e-4: tolerance 2e-4, as the 80-bin test
    (tests/test_torch_features.py). At 128 bins the empty filter's column is
    log(mel_floor) on both sides."""
    rng = np.random.default_rng(5)
    wav = np.zeros((2, S), np.float32)
    for i, n in enumerate((S, S - 7000)):
        w = utterance(n / 16000, rng)[0][:n]
        wav[i, :len(w)] = w
    if quiet:
        wav *= np.float32(1e-4)
    jcfg = JLogMelConfig(num_mel_bins=n_mel, norm_type="none", matmul_precision="highest")
    ref, _ = PallasLogMelFrontEnd(jcfg, interpret=True)(jnp.asarray(wav), jnp.full((2,), S, jnp.int32))
    cfg = LogMelConfig(num_mel_bins=n_mel)
    fe = K3.MelFrontEnd(cfg)
    got = K3.log_mel_plain(torch.from_numpy(wav), int(cfg.num_frames(S)), fe.dft, fe.mel, cfg.hop_length,
                           cfg.mel_floor).numpy()
    ref = _np(ref)
    assert got.shape == ref.shape == (2, 200, n_mel)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    if n_mel in EMPTY:
        assert np.all(got[..., EMPTY[n_mel]] == np.float32(np.log(np.float32(cfg.mel_floor))))


@pytest.mark.parametrize("mode", ["highest", "bf16"])
@pytest.mark.parametrize("n_mel", BINS)
def test_fused_cmvn_bf16_matches_pallas_interpret(noise, n_mel, mode):
    """``MelFrontEnd`` (plain log-mel, ``cmvn_plain``, bf16 out) against
    ``PallasLogMelFrontEnd(..., interpret=True, fused_cmvn_bf16=True)`` in the
    same DFT mode, every column but the empty filter's: "highest" within
    2e-2 (one bf16 rounding of values up to ~6), "bf16" within 2^-7 of the
    features' scale and 99 % bit for bit, the tolerances of the 80-bin tests
    (test_torch_features.py, test_torch_serving_profile.py). The empty
    filter's column holds ``COL3`` on both sides; rows past each length are
    zeros."""
    j_fe = PallasLogMelFrontEnd(JLogMelConfig(num_mel_bins=n_mel, matmul_precision=mode), interpret=True,
                                fused_cmvn_bf16=True)
    f_ref, l_ref = j_fe(jnp.asarray(noise), jnp.asarray(LENS))
    f_got, l_got = K3.MelFrontEnd(LogMelConfig(num_mel_bins=n_mel, matmul_precision=mode))(
        torch.from_numpy(noise), torch.from_numpy(LENS))
    assert f_got.dtype == torch.bfloat16 and f_got.shape == (3, 200, n_mel)
    np.testing.assert_array_equal(l_got.numpy(), np.asarray(l_ref))
    np.testing.assert_array_equal(l_got.numpy(), [150, 171, 200])
    g, r = f_got.float().numpy(), _np(f_ref)[:, :200]
    _check_empty_column(n_mel, g, r, [150, 171, 200])
    keep = _others(n_mel)
    g_k, r_k = g[..., keep], r[..., keep]
    assert np.isfinite(g_k).all() and np.isfinite(r_k).all()
    d = np.abs(g_k - r_k)
    if mode == "highest":
        assert d.max() <= 2e-2, d.max()
    else:
        assert d.max() <= 2 ** -7 * max(1.0, float(np.abs(r_k).max())), d.max()
        assert np.mean(d == 0) > 0.99, np.mean(d == 0)
    for i, n in enumerate((150, 171, 200)):
        assert np.all(g[i, n:] == 0.0)


FLAGSHIP = dict(hidden_size=256, num_hidden_layers=12, num_attention_heads=8, intermediate_size=1024,
                conv_dim=(256, 256), conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1), vocab_size=500)


def test_fused_gate_admits_every_bin_count_up_to_the_limit():
    """The flagship config on the CTC kernel route (``log_mel=True``) and a
    recipe route's front end are admitted at every count from 8 to
    ``MEL_MAX_BINS`` (128); past it both name the count and the limit."""
    assert K3.MEL_MAX_BINS == 128
    cuda = torch.device("cuda")  # the recipe gate reads the device type only
    for n_mel in range(8, K3.MEL_MAX_BINS + 1):
        cfg = EBranchformerConfig(num_fbanks=n_mel, **FLAGSHIP)
        assert fused_encoder_refusal(cfg, torch.bfloat16, log_mel=True) is None, n_mel
        assert recipe_frontend_refusal(cuda, n_mel, torch.bfloat16) is None, n_mel
    for n_mel in (129, 256):
        reason = fused_encoder_refusal(EBranchformerConfig(num_fbanks=n_mel, **FLAGSHIP), torch.bfloat16,
                                       log_mel=True)
        assert f"num_fbanks {n_mel}" in reason and "MEL_MAX_BINS = 128" in reason, reason
        reason = recipe_frontend_refusal(cuda, n_mel, torch.bfloat16)
        assert f"num_mel_bins {n_mel}" in reason and "MEL_MAX_BINS = 128" in reason, reason


@pytest.mark.parametrize("n_mel", [23, 40, 96, 128])
def test_fused_gate_admits_the_counts_users_run(n_mel):
    """The counts named by the gates' users (Kaldi's 23, 40, 96, Whisper
    large-v3's 128) on both gates, the plain front end building its bank and
    its bf16 kernel table for each."""
    cfg = EBranchformerConfig(num_fbanks=n_mel, **FLAGSHIP)
    assert fused_encoder_refusal(cfg, torch.bfloat16, log_mel=True) is None
    assert recipe_frontend_refusal(torch.device("cuda"), n_mel, torch.bfloat16) is None
    _, mel = K3.folded_bases(LogMelConfig(num_mel_bins=n_mel))
    table = K3.mel_kernel_table(mel)
    assert table.shape[0] >= n_mel + mel.shape[0] // K3.MEL_PASS_BINS
    assert int(K3.mel_bands(mel)[:n_mel, 1].sum()) == int((mel != 0).sum())
