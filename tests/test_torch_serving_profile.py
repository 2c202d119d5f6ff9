"""PyTorch port, the serving numeric profile against the JAX package's.

The JAX serving path (``huggingface_asr_tpu/serving/pipeline.py:86-113``)
sets ``set_numeric_profile("serving")`` and runs the log-mel kernel with
``matmul_precision="bf16"`` and the fused CMVN. The port's counterparts are
arguments: ``MelFrontEnd(LogMelConfig(matmul_precision=...))`` and the
``profile`` of K2, K1 and ``FusedCTC``. Each test feeds the same
numpy-seeded inputs to the JAX function in the same mode (interpret mode,
the profile set and restored to "bitexact" in a ``finally``) and to the
port's plain versions, with the tolerance it states. K3's DFT modes against
fp64, K1's layer, K2 and the whole route in the serving profile are in
``tests/test_torch_serving_route.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.ops import pallas_layer as PL
from huggingface_asr_tpu.ops.features import LogMelConfig as JLogMelConfig
from huggingface_asr_tpu.ops.pallas_features import PallasLogMelFrontEnd

from huggingface_asr_tpu_torch.kernels import layer as K1
from huggingface_asr_tpu_torch.kernels import mel as K3
from huggingface_asr_tpu_torch.ops.features import LogMelConfig


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
