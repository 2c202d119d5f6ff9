"""PyTorch port, the two depthwise convolutions of the fused layer vs the JAX package.

``csgu_plain`` and ``merge_conv_plain`` (what ``csgu`` and ``merge_conv`` run
on a CPU tensor, and what ``csrc/dwconv.cu`` is held to on the card) against
the chain inside the TPU kernel ``ops/pallas_layer.py::_layer_kernel``:
``_ln`` -> ``_dwconv`` (with its ``t_mask``) -> ``ACT_F32`` -> gate for CSGU,
``_dwconv`` -> bf16 -> residual add for merge, each called directly on
seeded numpy inputs.

Inputs are small integers times a power of two, so that every product and
partial sum of the convolution is exact in fp32 whatever the order of the
summation, and the channel counts are powers of two, so that the LayerNorm's
mean is exact too. Merge is then the same chain of operations on both sides
and is held bit for bit. CSGU also takes the LayerNorm's rsqrt and the
activations' transcendental functions, which come from two libraries and may
differ by an fp32 ulp, so after the bf16 rounding by one bf16 ulp: it is held
to 2^-7 of the output's scale, with at least 99.9 % of the elements bit-equal
(at these seeds one element in 40,960 differs, in one case).

Also here: the kernel's contract (``dwconv_contract``) refusing what
``csrc/dwconv.cu`` does not take, on CPU tensors; every shipped config that
the fused path takes staying inside it; and the reason the fused path gives
for refusing each shipped config.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.ops import pallas_layer as PL

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels import layer as K1
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.fast_infer import fused_encoder_ok, fused_encoder_refusal

B, T, EPS = 2, 40, 1e-5
BF = jnp.bfloat16


def _inputs(seed, C, K, width_factor):
    rng = np.random.default_rng(seed)
    x = rng.integers(-16, 17, (B * T, width_factor * C)).astype(np.float32) * 2.0 ** -3
    w = rng.integers(-8, 9, (K, C)).astype(np.float32) * 2.0 ** -5
    bias = rng.integers(-16, 17, C).astype(np.float32) * 2.0 ** -4
    ln_g = 1.0 + rng.integers(-8, 9, C).astype(np.float32) * 2.0 ** -4
    ln_b = rng.integers(-8, 9, C).astype(np.float32) * 2.0 ** -4
    return x, w, bias, ln_g, ln_b


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32) if hasattr(a, "dtype") and a.dtype == BF else a, np.float32)


def _t_mask(t_valid):
    return jnp.asarray(np.arange(T)[None, :, None] < t_valid)


def _jax_csgu(l, w, bias, ln_g, ln_b, t_valid, act):
    C = l.shape[1] // 2
    l = jnp.asarray(l, BF)
    x_g = PL._ln(l[:, C:], jnp.asarray(ln_g)[None, :], jnp.asarray(ln_b)[None, :], EPS)
    acc = PL._dwconv(x_g.reshape(B, T, C), jnp.asarray(w, BF), jnp.asarray(bias)[None, :], w.shape[0],
                     _t_mask(t_valid))
    gate = PL.ACT_F32[act](acc).astype(BF).reshape(B * T, C)
    return _np(l[:, :C] * gate)


def _jax_merge(x, w, bias, t_valid):
    C = x.shape[1]
    x = jnp.asarray(x, BF)
    fused = PL._dwconv(x.reshape(B, T, C), jnp.asarray(w, BF), jnp.asarray(bias)[None, :], w.shape[0],
                       _t_mask(t_valid)).astype(BF).reshape(B * T, C)
    return _np(x + fused)


def _port_csgu(l, w, bias, ln_g, ln_b, t_valid, act):
    return K1.csgu(l, _t(ln_g, torch.float32), _t(ln_b, torch.float32), _t(w), _t(bias, torch.float32),
                   B, T, t_valid, act, EPS).float().numpy()


def _compare(got, ref, exact):
    assert np.isfinite(got).all()
    if exact:
        np.testing.assert_array_equal(got, ref)
        return
    d = np.abs(got - ref)
    assert d.max() <= 2 ** -7 * max(1.0, np.abs(ref).max()), d.max()
    assert np.mean(d == 0) >= 0.999, np.mean(d == 0)


T_VALIDS = [1, T - 5, T]


@pytest.mark.parametrize("t_valid", T_VALIDS)
@pytest.mark.parametrize("C", [64, 512, 1024])
@pytest.mark.parametrize("K", [3, 7, 31, 33])
def test_merge_plain_is_bit_equal_to_jax(K, C, t_valid):
    x, w, bias, _, _ = _inputs(K + C + t_valid, C, K, 1)
    ref = _jax_merge(x, w, bias, t_valid)
    got = K1.merge_conv(_t(x), _t(w), _t(bias, torch.float32), B, T, t_valid).float().numpy()
    _compare(got, ref, exact=True)


@pytest.mark.parametrize("t_valid", T_VALIDS)
@pytest.mark.parametrize("C", [64, 512, 1024])
@pytest.mark.parametrize("K", [3, 7, 31, 33])
def test_csgu_plain_matches_jax(K, C, t_valid):
    l, w, bias, ln_g, ln_b = _inputs(K + C + t_valid, C, K, 2)
    ref = _jax_csgu(l, w, bias, ln_g, ln_b, t_valid, "identity")
    got = _port_csgu(_t(l), w, bias, ln_g, ln_b, t_valid, "identity")
    _compare(got, ref, exact=False)


@pytest.mark.parametrize("act", sorted(K1.ACT_CODES))
def test_csgu_plain_activations_match_jax(act):
    l, w, bias, ln_g, ln_b = _inputs(3, 64, 7, 2)
    ref = _jax_csgu(l, w, bias, ln_g, ln_b, T - 5, act)
    got = _port_csgu(_t(l), w, bias, ln_g, ln_b, T - 5, act)
    _compare(got, ref, exact=False)


def test_csgu_plain_on_a_strided_l():
    """``l`` as a column view of a wider buffer gives what a contiguous ``l`` gives."""
    C = 64
    l, w, bias, ln_g, ln_b = _inputs(5, C, 31, 2)
    wide = torch.zeros(B * T, 2 * C + 16, dtype=torch.bfloat16)
    wide[:, 8:8 + 2 * C] = _t(l)
    view = wide[:, 8:8 + 2 * C]
    got = _port_csgu(view, w, bias, ln_g, ln_b, T - 5, "identity")
    np.testing.assert_array_equal(got, _port_csgu(_t(l), w, bias, ln_g, ln_b, T - 5, "identity"))
    _compare(got, _jax_csgu(l, w, bias, ln_g, ln_b, T - 5, "identity"), exact=False)


def test_cpu_convs_launch_nothing():
    x, w, bias, ln_g, ln_b = _inputs(0, 64, 7, 2)
    _build.reset_launch_counts()
    _port_csgu(_t(x), w, bias, ln_g, ln_b, T, "identity")
    K1.merge_conv(_t(x[:, :64]), _t(w), _t(bias, torch.float32), B, T, T)
    assert sum(_build.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# The kernel's contract, checked on CPU tensors


def _contract_case(name):
    """(mode, x, w, bias, t_valid, ln_g, ln_b) that the kernel takes, but for ``name``."""
    C, K = 64, 7
    mode = 1 if name.startswith("merge") else 0
    x = torch.zeros(B * T, 2 * C if mode == 0 else C, dtype=torch.bfloat16)
    w = torch.zeros(K, C, dtype=torch.bfloat16)
    bias, ln_g, ln_b = torch.zeros(C), torch.ones(C), torch.zeros(C)
    t_valid = T
    if name == "even K":
        w = torch.zeros(6, C, dtype=torch.bfloat16)
    elif name == "K > 33":
        w = torch.zeros(35, C, dtype=torch.bfloat16)
    elif name == "C % 8":
        x, w, bias, ln_g, ln_b = (torch.zeros(B * T, 120, dtype=torch.bfloat16), torch.zeros(K, 60, dtype=torch.bfloat16),
                                  torch.zeros(60), torch.ones(60), torch.zeros(60))
    elif name == "C > 768":  # past 768 CSGU runs 128-channel slices: 776 is no whole number of them
        x, w, bias, ln_g, ln_b = (torch.zeros(B * T, 1552, dtype=torch.bfloat16), torch.zeros(K, 776, dtype=torch.bfloat16),
                                  torch.zeros(776), torch.ones(776), torch.zeros(776))
    elif name == "csgu C > 1024":
        x, w, bias, ln_g, ln_b = (torch.zeros(B * T, 2304, dtype=torch.bfloat16), torch.zeros(K, 1152, dtype=torch.bfloat16),
                                  torch.zeros(1152), torch.ones(1152), torch.zeros(1152))
    elif name == "merge C > 1024":
        x, w, bias = (torch.zeros(B * T, 1032, dtype=torch.bfloat16), torch.zeros(K, 1032, dtype=torch.bfloat16),
                      torch.zeros(1032))
    elif name == "x fp32":
        x = x.float()
    elif name == "x rows":
        x = x[:-1]
    elif name == "x odd width":
        x = torch.zeros(B * T, 2 * C + 1, dtype=torch.bfloat16)
    elif name == "x row stride":
        x = torch.zeros(B * T, 2 * C + 4, dtype=torch.bfloat16)[:, :2 * C]
    elif name == "x base":
        x = torch.zeros(B * T, 2 * C + 8, dtype=torch.bfloat16)[:, 4:4 + 2 * C]
    elif name == "x column stride":
        x = torch.zeros(2 * C, B * T, dtype=torch.bfloat16).t()
    elif name == "w fp32":
        w = w.float()
    elif name == "w shape":
        w = torch.zeros(K, C + 8, dtype=torch.bfloat16)
    elif name == "bias bf16":
        bias = bias.bfloat16()
    elif name == "ln_g shape":
        ln_g = torch.ones(C + 8)
    elif name == "ln_b bf16":
        ln_b = ln_b.bfloat16()
    elif name == "negative t_valid":
        t_valid = -1
    elif name == "merge x width":
        x = torch.zeros(B * T, 2 * C, dtype=torch.bfloat16)
    return mode, x, w, bias, t_valid, ln_g, ln_b


REFUSED = ["even K", "K > 33", "C % 8", "C > 768", "csgu C > 1024", "merge C > 1024", "x fp32", "x rows", "x odd width", "x row stride",
           "x base", "x column stride", "w fp32", "w shape", "bias bf16", "ln_g shape", "ln_b bf16",
           "negative t_valid", "merge x width"]


@pytest.mark.parametrize("name", REFUSED)
def test_contract_refuses(name):
    mode, x, w, bias, t_valid, ln_g, ln_b = _contract_case(name)
    with pytest.raises(ValueError):
        K1.dwconv_contract(mode, x, w, bias, B, T, t_valid, ln_g, ln_b)


@pytest.mark.parametrize("name", ["csgu", "merge"])
def test_contract_takes_the_layers_calls(name):
    mode, x, w, bias, t_valid, ln_g, ln_b = _contract_case(name)
    assert K1.dwconv_contract(mode, x, w, bias, B, T, t_valid, ln_g, ln_b) == 64
    # CSGU's l as a row view of a wider buffer, K = 1 and K = 33, t_valid past T
    wide = torch.zeros(B * T, 256, dtype=torch.bfloat16)
    assert K1.dwconv_contract(0, wide[:, 64:192], torch.zeros(33, 64, dtype=torch.bfloat16), bias, B, T, T + 3,
                              ln_g, ln_b) == 64
    assert K1.dwconv_contract(1, wide[:, :64], torch.zeros(1, 64, dtype=torch.bfloat16), bias, B, T, 0) == 64


CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
# Why the fused serving path refuses each shipped config (None: it takes it).
# An encoder-decoder file is judged by its encoder.
REFUSAL = {
    "decred_base.json": None,
    "decred_small.json": None,
    "ebranchformer_30m_ssl.json": None,
    "ebranchformer_90m_ssl.json": None,
    "ebranchformer_base_ctc.json": None,
    "ebranchformer_small_ctc.json": None,
    "ed_base.json": None,
    "ed_small.json": None,
}


def _config(name):
    with open(os.path.join(CONFIG_DIR, name)) as f:
        d = json.load(f)
    return EBranchformerConfig.from_dict(d.get("encoder", d))


def test_every_config_file_has_its_refusal_listed():
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONFIG_DIR, "*.json"))) == sorted(REFUSAL)


@pytest.mark.parametrize("name", sorted(REFUSAL))
def test_fused_refusal_of_each_config(name):
    cfg = _config(name)
    assert fused_encoder_refusal(cfg, torch.bfloat16) == REFUSAL[name]
    assert fused_encoder_ok(cfg, torch.bfloat16) == (REFUSAL[name] is None)
    assert fused_encoder_refusal(cfg, torch.float32) == (REFUSAL[name] or "dtype torch.float32 (the kernels run bfloat16)")


@pytest.mark.parametrize("name", sorted(n for n, r in REFUSAL.items() if r is None))
def test_fused_configs_are_inside_the_dwconv_contract(name):
    """Both convs of every config the fused path takes, at its own C and K."""
    cfg = _config(name)
    D, Cg = cfg.hidden_size, cfg.intermediate_size // 2
    zeros = lambda *s, dtype=torch.float32: torch.zeros(*s, dtype=dtype)  # noqa: E731
    assert K1.dwconv_contract(0, zeros(B * T, 2 * Cg, dtype=torch.bfloat16),
                              zeros(cfg.csgu_kernel_size, Cg, dtype=torch.bfloat16), zeros(Cg), B, T, T,
                              zeros(Cg), zeros(Cg)) == Cg
    assert K1.dwconv_contract(1, zeros(B * T, 2 * D, dtype=torch.bfloat16),
                              zeros(cfg.merge_conv_kernel, 2 * D, dtype=torch.bfloat16), zeros(2 * D), B, T, T) == 2 * D


def test_refusal_names_the_first_failed_condition():
    cfg = _config("ebranchformer_base_ctc.json")
    assert fused_encoder_refusal(cfg, torch.bfloat16) is None
    worse = dataclasses.replace(cfg, is_causal=True, hidden_size=176)
    assert fused_encoder_refusal(worse, torch.bfloat16) == "the model is causal"
