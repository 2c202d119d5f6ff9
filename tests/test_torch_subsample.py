"""PyTorch port, conv subsampler (K2) vs the JAX package.

The plain subsampler (what a CPU tensor runs) is held against the Pallas
kernel ``conv_subsample_fused(..., interpret=True)`` on the same params and
seeded features, as tests/test_pallas_subsample.py runs it.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.ops.pallas_subsample import conv_subsample_fused
from huggingface_asr_tpu.ops.pallas_subsample import fits_subsample_kernel as j_fits
from huggingface_asr_tpu.ops.pallas_subsample import fold_subsample_weights as j_fold
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.kernels import subsample as K2


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg, tree, _, pmodel = make_models(seed=3, hidden_size=256, num_hidden_layers=1)
    w = K2.fold_subsample_weights(pmodel.wav2vec2, pcfg)
    return jcfg, pcfg, tree, w


def _np(a):
    return np.asarray(a, np.float32)


def test_fold_matches_jax(models):
    jcfg, pcfg, tree, w = models
    j = j_fold(tree["wav2vec2"], jcfg)
    C, D = 256, jcfg.hidden_size
    np.testing.assert_array_equal(w["w2"].float().numpy(), _np(j["sub_W2"]).reshape(9 * C, C))
    np.testing.assert_array_equal(w["wout"].float().numpy(), _np(j["sub_Wout"]).reshape(-1, D))
    np.testing.assert_array_equal(w["wproj"].float().numpy(), _np(j["sub_Wproj"]))
    # conv1 taps: JAX packs both output parities into a (16, 2C) im2col matrix;
    # its even-parity rows (r, kf) for r < 3 are exactly the (kt, kf) taps.
    np.testing.assert_array_equal(w["w1"].float().numpy(), _np(j["sub_B"])[:9, :C])
    for name, jname in (("b1", "sub_b1"), ("b2", "sub_b2"), ("bout", "sub_bout"),
                        ("bproj", "sub_bproj"), ("ln_g", "sub_ln_g"), ("ln_b", "sub_ln_b")):
        np.testing.assert_array_equal(w[name].numpy(), _np(j[jname]).reshape(-1)[: w[name].shape[0]])


@pytest.mark.parametrize("t_in", [96, 100])  # 4-aligned and odd-tail shapes
def test_plain_subsample_matches_pallas_interpret(models, t_in):
    """Tolerance 6e-2 as tests/test_pallas_subsample.py:69: identical rounding
    points; fp32 accumulation order and the GELU's rounding chain flip
    isolated bf16 ulps, which the LN + projection tail amplifies."""
    jcfg, pcfg, tree, w = models
    feats = np.random.default_rng(0).standard_normal((2, t_in, 80)).astype(np.float32)
    T2 = ((t_in - 1) // 2) // 2 + 1
    T2_pad = -(-T2 // 8) * 8
    ref = _np(conv_subsample_fused(tree["wav2vec2"], jcfg, jnp.asarray(feats), T2_pad=T2_pad,
                                   interpret=True))[:, :T2]
    got = K2.conv_subsample(torch.from_numpy(feats), w, pcfg, T2_pad)
    assert got.shape == (2, T2_pad, jcfg.hidden_size) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy()[:, :T2], ref, rtol=0, atol=6e-2)


def _jax_conv2(y1, w2, b2):
    """conv2 in JAX ops with the TPU kernel's expression (``_subsample_kernel``:
    ``acc2.astype(bf) + b2`` in bf16, then the bf16 ``jax.nn.gelu`` whose
    rounding chain the kernel's GELU replicates)."""
    C = y1.shape[-1]
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(y1, jnp.float32), jnp.asarray(w2, jnp.float32).reshape(3, 3, C, C), (2, 2),
        ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST)
    y2 = acc.astype(jnp.bfloat16) + jnp.asarray(b2, jnp.bfloat16)[None, None, None, :]
    return _np(jax.nn.gelu(y2, approximate=False))


def test_conv2_plain_rounds_the_sum_before_the_bias():
    """Pins the rounding points the CUDA conv2 relies on:
    ``GELU(bf16(bf16(acc) + b2))``. Crafted so that the order shows: the
    centre tap sums 1 + 2^-8 (a bf16 tie, rounds to 1), the bias adds 2^-8
    (a tie again, 1), where one rounding of acc + b2 gives 1 + 2^-7."""
    C, T1, F1 = 16, 5, 4
    y1 = np.zeros((1, T1, F1, C), np.float32)
    y1[..., 0], y1[..., 1] = 1.0, 2.0 ** -8
    w2 = np.zeros((3, 3, C, C), np.float32)
    w2[1, 1, 0, 0] = w2[1, 1, 1, 0] = 1.0
    b2 = np.zeros(C, np.float32)
    b2[0] = 2.0 ** -8
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    T2 = (T1 - 1) // 2 + 1
    got = K2.conv2_plain(bf(y1), bf(w2.reshape(9 * C, C)), torch.from_numpy(b2), T2)
    got = got.float().numpy().reshape(1, T2, F1 // 2, C)
    ref = _jax_conv2(y1, w2, b2)
    np.testing.assert_array_equal(got, ref)
    gelu = lambda v: float(torch.nn.functional.gelu(torch.tensor(v)).bfloat16())  # noqa: E731
    assert got[0, 0, 0, 0] == gelu(1.0) != gelu(1.0 + 2.0 ** -7)
    assert got[0, 0, 0, 1] == 0.0


def test_conv2_plain_matches_jax_ops():
    """Seeded operands: against the same JAX expression within one bf16 ulp of
    the scale (fp32 sums in another order; JAX's GELU is a chain of bf16 ops,
    the port's one fp32 evaluation rounded once)."""
    rng = np.random.default_rng(4)
    C, T1, F1 = 32, 9, 8
    bfr = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    y1, w2 = bfr(rng.standard_normal((2, T1, F1, C))), bfr(rng.standard_normal((9 * C, C)) * 0.06)
    b2 = bfr(rng.standard_normal(C) * 0.1).float()
    T2 = (T1 - 1) // 2 + 1
    got = K2.conv2_plain(y1, w2, b2, T2).float().numpy().reshape(2, T2, F1 // 2, C)
    ref = _jax_conv2(y1.float().numpy(), w2.float().numpy(), b2.numpy())
    assert np.abs(got - ref).max() <= 2 ** -7 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("change", [
    {}, {"conv_dim": (128, 128)}, {"is_causal": True}, {"context_awareness_type": "gated"},
    {"conv_stride": (2, 1)}, {"feat_extract_activation": "relu"}, {"num_fbanks": 64},
])
def test_gate_matches_jax(models, change):
    jcfg, pcfg, _, _ = models
    assert K2.fits_subsample_kernel(dataclasses.replace(pcfg, **change)) == j_fits(
        dataclasses.replace(jcfg, **change))


def _conv1_table_constants():
    """G_LO and G_N of csrc/subsample.cu: the bf16 bits where conv1's GELU
    table starts and its entries a sign."""
    src = (Path(K2.__file__).resolve().parent.parent / "csrc" / "subsample.cu").read_text()
    get = lambda name: int(re.search(rf"constexpr uint32_t {name} = (0x[0-9A-Fa-f]+)u;", src).group(1), 16)  # noqa: E731
    return get("G_LO"), get("G_N")


@pytest.mark.parametrize("half", ["low", "high"])
def test_conv1_gelu_table_window_on_every_bf16_pattern(half):
    """The CUDA conv1 looks a bf16 value's GELU up in a table of the values of
    magnitude [2^-24, 2^8) and computes it elsewhere. Its checks, mirrored on
    all 65,536 bit patterns in numpy: a value is taken from the table exactly
    when it lies in that range (finite, both signs), and its entry (at 2 (bits
    - G_LO) bytes) lies inside the table's two halves; the packed check of a
    pair (bits 12-14 of each half of ``q - (G_LO | G_LO << 16)``) passes only
    when both halves are in the table, whatever the other half holds."""
    lo, n = _conv1_table_constants()
    bits = np.arange(65536, dtype=np.uint32)
    x = (bits << 16).view(np.float32)
    with np.errstate(invalid="ignore"):
        want = np.isfinite(x) & (np.abs(x) >= 2.0 ** -24) & (np.abs(x) < 2.0 ** 8)
    d = (bits - np.uint32(lo)) & np.uint32(0xFFFFFFFF)
    inside = (d & 0x7000) == 0
    np.testing.assert_array_equal(inside, want)
    assert np.all((d[inside] < n) | ((d[inside] >= 0x8000) & (d[inside] < 0x8000 + n)))
    assert int(inside.sum()) == 2 * n
    # the packed check against every pattern in this half beside a sample of the other half's
    others = np.concatenate([np.arange(0, 65536, 97, dtype=np.uint32), np.uint32([0, lo - 1, lo, 0x7F80, 0xFFFF])])
    for o in others:
        q = (bits | (o << 16)) if half == "low" else ((bits << 16) | o)
        t = (q - np.uint32(lo | lo << 16)) & np.uint32(0xFFFFFFFF)
        both = inside & inside[o]
        np.testing.assert_array_equal((t & 0x70007000) == 0, both)
