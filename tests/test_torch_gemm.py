"""PyTorch port, the GEMM with fused epilogue vs the JAX package's expressions.

``gemm_plain`` (what ``gemm`` runs on a CPU tensor, and what the CUDA kernel
is held to on the card) against the expressions inside the TPU kernels:
``_mm`` + bias, activation and residual of ``ops/pallas_layer.py`` and the
round-before-bias dense of ``ops/pallas_subsample.py``.

Inputs are seeded numpy arrays of small integers times a power of two, so that
every product and every partial sum is exact in fp32 whatever the order of the
summation: where the JAX expression is the same chain of roundings the two
results are bit-equal. Only the GELU and swish cases carry a tolerance (XLA
rounds GELU's intermediate products to bf16, which the TPU kernel replays; the
port evaluates erfc once in fp32): 2^-6 of the output's scale.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.ops import pallas_layer as PL

from huggingface_asr_tpu_torch.kernels import layer as K1
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.fast_infer import fused_encoder_ok

M, K, N = 40, 96, 128
BF = jnp.bfloat16


def _inputs(seed, m=M, k=K, n=N):
    rng = np.random.default_rng(seed)
    a = rng.integers(-8, 9, (m, k)).astype(np.float32)
    w = rng.integers(-4, 5, (k, n)).astype(np.float32) * 2.0 ** -5
    bias = rng.integers(-64, 65, n).astype(np.float32) * 2.0 ** -4   # bf16-exact
    res = rng.integers(-100, 101, (m, n)).astype(np.float32) * 2.0 ** -3
    return a, w, bias, res


def _t(x, dtype=torch.bfloat16):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _np(x):
    return np.asarray(x.astype(jnp.float32) if hasattr(x, "astype") and x.dtype == BF else x, np.float32)


def _jax_mm(a, w, bias):
    """``pallas_layer._mm`` on arrays (it reads its weight and bias through refs)."""
    return PL._mm(jnp.asarray(a, BF), jnp.asarray(w, BF), jnp.asarray(bias, BF)[None, :])


def test_mm_bias_is_bit_equal():
    a, w, bias, _ = _inputs(0)
    got = K1.gemm(_t(a), _t(w), _t(bias, torch.float32))
    np.testing.assert_array_equal(got.float().numpy(), _np(_jax_mm(a, w, bias)))


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_mm_residual_is_bit_equal(alpha):
    """x + alpha * FF(...) as ``_layer_kernel`` writes it: both terms in fp32, one rounding."""
    a, w, bias, res = _inputs(1)
    h = _jax_mm(a, w, bias)
    ref = (jnp.asarray(res, BF).astype(jnp.float32) + alpha * h.astype(jnp.float32)).astype(BF)
    got = K1.gemm(_t(a), _t(w), _t(bias, torch.float32), residual=_t(res), alpha=alpha)
    np.testing.assert_array_equal(got.float().numpy(), _np(ref))


@pytest.mark.parametrize("act", ["relu", "swish"])
def test_mm_activation_is_bit_equal(act):
    a, w, bias, _ = _inputs(2)
    ref = PL.ACT_BF16[act](_jax_mm(a, w, bias))
    got = K1.gemm(_t(a), _t(w), _t(bias, torch.float32), act=act)
    g, r = got.float().numpy(), _np(ref)
    if act == "relu":
        np.testing.assert_array_equal(g, r)
    else:  # exp of two libraries: the last bf16 bit may differ
        assert np.abs(g - r).max() <= 2 ** -7 * max(1.0, np.abs(r).max())
        assert np.mean(g == r) > 0.99


@pytest.mark.parametrize("act,fn", [("gelu", lambda x: jax.nn.gelu(x, approximate=False)),
                                    ("gelu_new", lambda x: jax.nn.gelu(x, approximate=True))])
def test_mm_gelu_within_two_ulp(act, fn):
    """Against the activation as the JAX model applies it to the bf16 product
    (the chain the TPU kernel's 'bitexact' mode replays; that replica itself
    evaluates only inside a Pallas kernel)."""
    a, w, bias, _ = _inputs(3)
    ref = _np(fn(_jax_mm(a, w, bias)))
    got = K1.gemm(_t(a), _t(w), _t(bias, torch.float32), act=act).float().numpy()
    assert np.abs(got - ref).max() <= 2 ** -6 * max(1.0, np.abs(ref).max())
    assert np.abs(got - ref).mean() <= 2 ** -8


def test_dual_output_is_bit_equal():
    """One product, two biases: q_u and q_v of ``_layer_kernel``, beside k and v."""
    D = 64
    a, w, bias, _ = _inputs(4, n=3 * D)
    bias2 = np.random.default_rng(5).integers(-64, 65, D).astype(np.float32) * 2.0 ** -4
    qq = jnp.dot(jnp.asarray(a, BF), jnp.asarray(w[:, :D], BF), preferred_element_type=jnp.float32)
    q_u = (qq + jnp.asarray(bias[:D])).astype(BF)
    q_v = (qq + jnp.asarray(bias2)).astype(BF)
    kv = _jax_mm(a, w[:, D:], bias[D:])
    qkv, out2 = K1.gemm(_t(a), _t(w), _t(bias, torch.float32), bias2=_t(bias2, torch.float32))
    np.testing.assert_array_equal(qkv[:, :D].float().numpy(), _np(q_u))
    np.testing.assert_array_equal(qkv[:, D:].float().numpy(), _np(kv))
    np.testing.assert_array_equal(out2.float().numpy(), _np(q_v))


def test_round_first_is_bit_equal():
    """The subsampler's dense: the fp32 sum rounds to bf16 before the bias joins (in bf16)."""
    a, w, bias, _ = _inputs(6)
    proj = jnp.dot(jnp.asarray(a, BF), jnp.asarray(w, BF), preferred_element_type=jnp.float32)
    ref = proj.astype(BF) + jnp.asarray(bias, BF)[None, :]
    got = K1.gemm(_t(a), _t(w), _t(bias, torch.float32), round_first=True)
    np.testing.assert_array_equal(got.float().numpy(), _np(ref))
    # and it is another function than the round-once form
    once = K1.gemm(_t(a), _t(w) * 1.01, _t(bias, torch.float32))
    twice = K1.gemm(_t(a), _t(w) * 1.01, _t(bias, torch.float32), round_first=True)
    assert not torch.equal(once, twice)


@pytest.mark.parametrize("half", [0, 1])
def test_strided_a_and_sliced_out(half):
    """``a`` a column view of a wider buffer, ``out`` one half of ``merged``: the
    other half and the rows below stay as they were."""
    a, w, bias, _ = _inputs(7 + half)
    wide = torch.zeros(M, 2 * K, dtype=torch.bfloat16)
    wide[:, K:] = _t(a)
    merged = torch.full((M + 3, 2 * N), 7.0, dtype=torch.bfloat16)
    out = merged[:M, half * N:(half + 1) * N]
    got = K1.gemm(wide[:, K:], _t(w), _t(bias, torch.float32), out=out)
    assert got.data_ptr() == out.data_ptr()
    np.testing.assert_array_equal(out.float().numpy(), _np(_jax_mm(a, w, bias)))
    assert bool((merged[:M, (1 - half) * N:(2 - half) * N] == 7.0).all())
    assert bool((merged[M:] == 7.0).all())


def _refusal_case(name):
    a = torch.zeros(16, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 128, dtype=torch.bfloat16)
    out = res = bias2 = None
    if name == "N % 8":
        w = torch.zeros(64, 100, dtype=torch.bfloat16)
    elif name == "K % 8":
        a, w = torch.zeros(16, 44, dtype=torch.bfloat16), torch.zeros(44, 128, dtype=torch.bfloat16)
    elif name == "a row stride":
        a = torch.zeros(16, 68, dtype=torch.bfloat16)[:, :64]
    elif name == "a column stride":
        a = torch.zeros(64, 16, dtype=torch.bfloat16).t()
    elif name == "a base":
        a = torch.zeros(16, 72, dtype=torch.bfloat16)[:, 4:68]
    elif name == "out base":
        out = torch.zeros(16, 136, dtype=torch.bfloat16)[:, 4:132]
    elif name == "out row stride":
        out = torch.zeros(16, 132, dtype=torch.bfloat16)[:, :128]
    elif name == "out shape":
        out = torch.zeros(16, 64, dtype=torch.bfloat16)
    elif name == "residual row stride":
        res = torch.zeros(16, 132, dtype=torch.bfloat16)[:, :128]
    elif name == "residual base":
        res = torch.zeros(16, 136, dtype=torch.bfloat16)[:, 4:132]
    elif name == "bias2 % 8":
        bias2 = torch.zeros(20)
    elif name == "bias2 > N":
        bias2 = torch.zeros(136)
    return a, w, out, res, bias2


@pytest.mark.parametrize("name", [
    "N % 8", "K % 8", "a row stride", "a column stride", "a base", "out base", "out row stride",
    "out shape", "residual row stride", "residual base", "bias2 % 8", "bias2 > N",
])
def test_contract_refuses(name):
    with pytest.raises(ValueError):
        K1.gemm_contract(*_refusal_case(name))


def test_contract_takes_the_layers_calls():
    a, w, out, res, bias2 = _refusal_case("none")
    K1.gemm_contract(a, w, out, res, bias2)
    merged = torch.zeros(16, 256, dtype=torch.bfloat16)
    K1.gemm_contract(a, w, merged[:, :128], torch.zeros(16, 128, dtype=torch.bfloat16), torch.zeros(64))
    K1.gemm_contract(merged[:, 128:192], w, merged[:, 128:])


# What ``fused_encoder_ok`` said of every file under configs/ before the GEMM
# moved to wgmma + TMA: no file may lose the fused path as the kernel's shape
# contract changes.
FUSED_BEFORE = {  # (an encoder-decoder file is judged by its encoder)
    "decred_base.json": True, "decred_small.json": False, "ebranchformer_30m_ssl.json": True,
    "ebranchformer_90m_ssl.json": False, "ebranchformer_base_ctc.json": True,
    "ebranchformer_small_ctc.json": False, "ed_base.json": True, "ed_small.json": False,
}
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def test_every_config_file_is_listed():
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONFIG_DIR, "*.json"))) == sorted(FUSED_BEFORE)


@pytest.mark.parametrize("name", sorted(FUSED_BEFORE))
def test_configs_keep_the_fused_path(name):
    with open(os.path.join(CONFIG_DIR, name)) as f:
        d = json.load(f)
    cfg = EBranchformerConfig.from_dict(d.get("encoder", d))
    ok = fused_encoder_ok(cfg, torch.bfloat16)
    assert ok or not FUSED_BEFORE[name]
    if ok:
        # every product of the layer and the subsampler is inside the GEMM's contract
        D, I = cfg.hidden_size, cfg.intermediate_size
        for k, n in ((D, I), (I, D), (D, 3 * D), (D, D), (2 * D, D)):
            K1.gemm_contract(torch.zeros(8, k, dtype=torch.bfloat16), torch.zeros(k, n, dtype=torch.bfloat16))
