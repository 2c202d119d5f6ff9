"""PyTorch port: the GEMM with a LayerNorm prologue (``kernels/layer.py::ln_gemm``,
``csrc/gemm_ln.cu``) against the JAX package's ``_ln`` and ``_mm``.

The kernel cannot run here, so (a) mirrors its arithmetic in numpy, operation
by operation (``csrc/gemm.cuh::ln_rows`` and ``ln_box`` over
``csrc/common.cuh``'s ``ln_*`` steps): its sums equal the standalone
LayerNorm's bit for bit, and its output ``pallas_layer.py::_ln``'s but for
isolated roundings; (b) holds the plain version, which a CPU tensor runs,
against ``_ln`` then ``_mm`` at each call site's epilogue; (c) the contract
against ``fused_encoder_refusal`` and the shipped configs; (d) counts the
layer's calls through a recording ``ops`` namespace. The kernel's own bits
are held on the card (``tests/test_torch_cuda.py``).
"""

import json
import pathlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.ops import pallas_layer as PL
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.kernels import layer as K1
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.fast_infer import fused_encoder_refusal

EPS = 1e-5
F32 = np.float32


def _fma(a, b, c):
    """fp32 fused multiply-add, elementwise: the product exact in float64, one
    rounding of the sum (float64 then float32 can differ from one rounding
    only where the exact sum lies within 2^-53 of a float32 midpoint)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F32)


def _bf16_bits(v):
    """Round-to-nearest-even float32 -> bf16, as the bits (finite values)."""
    u = v.astype(F32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _bits_to_f32(b):
    return (b.astype(np.uint32) << 16).view(F32)


def standalone_sums(x):
    """``layer.cu::layernorm_kernel``'s row sums of x and x^2, (M,) each: lane
    v adds columns v, v + 32, ... in increasing order (s + v, then v * v + ss
    in one FMA), then ``warp_sum``: lane bits 4 to 0, each lane adding its
    partner's sum to its own."""
    M, K = x.shape
    s = np.zeros((M, 32), F32)
    ss = np.zeros((M, 32), F32)
    for c0 in range(0, K, 32):
        lanes = np.arange(min(32, K - c0))
        v = x[:, c0 + lanes]
        s[:, lanes] = (s[:, lanes] + v).astype(F32)
        ss[:, lanes] = _fma(v, v, ss[:, lanes])
    for o in (16, 8, 4, 2, 1):
        partner = np.arange(32) ^ o
        s, ss = (s + s[:, partner]).astype(F32), (ss + ss[:, partner]).astype(F32)
    assert (s == s[:, :1]).all() and (ss == ss[:, :1]).all()  # a + b == b + a: every lane holds the total
    return s[:, 0], ss[:, 0]


def prologue_sums(x):
    """``gemm.cuh::ln_rows``'s row sums (the same for 8 or 16 rows a warp):
    lane L = 4 h + u of a warp reads the 16-byte chunks at columns 32 i + 8 u
    .. + 7 of its rows and holds the sums of the standalone kernel's lanes 8 u
    + e, e < 8 (axis 1 is u, axis 2 e); the butterfly is shuffles across u
    (xor 2, then 1: lane bits 4 and 3) and then adds inside the lane (e xor 4,
    2, 1)."""
    M, K = x.shape
    s = np.zeros((M, 4, 8), F32)
    ss = np.zeros((M, 4, 8), F32)
    for c0 in range(0, K, 32):
        for u in range(4):
            if c0 + 8 * u >= K:  # K % 8 == 0: a chunk lies wholly below K or wholly past it
                continue
            v = x[:, c0 + 8 * u:c0 + 8 * u + 8]
            s[:, u] = (s[:, u] + v).astype(F32)
            ss[:, u] = _fma(v, v, ss[:, u])
    for o in (2, 1):
        partner = np.arange(4) ^ o
        s, ss = (s + s[:, partner]).astype(F32), (ss + ss[:, partner]).astype(F32)
    for o in (4, 2, 1):
        s, ss = (s[..., :o] + s[..., o:2 * o]).astype(F32), (ss[..., :o] + ss[..., o:2 * o]).astype(F32)
    return s[:, 0, 0], ss[:, 0, 0]


def mirror_prologue(x_bits, M, g, b, eps):
    """The kernel's operand, as bf16 bits (M_pad, K_pad): ``prologue_sums``
    over rows in warps of 16 (rows at or past M read as zeros),
    ``common.cuh::ln_finish`` and then ``ln_apply`` on each value of the
    64-column boxes, whose columns past K (the TMA's zeros) take g = b = 0.
    The rsqrt here is the correctly rounded one; the card's ``rsqrtf`` is
    within 2 ulps of it (the kernel's own bits are held on the card)."""
    M_pad, K = x_bits.shape
    K_pad = -(-K // 64) * 64
    x = _bits_to_f32(x_bits)
    x[M:] = 0.0
    s, ss = prologue_sums(x)
    s0, ss0 = standalone_sums(x)
    np.testing.assert_array_equal(s, s0)  # the same sums, bit for bit, as the standalone kernel
    np.testing.assert_array_equal(ss, ss0)
    Kf = F32(K)
    mu = (s / Kf).astype(F32)
    var = np.maximum(_fma(-mu, mu, (ss / Kf).astype(F32)), F32(0.0))
    r = (1.0 / np.sqrt((var + F32(eps)).astype(F32).astype(np.float64))).astype(F32)
    gp, bp = np.zeros(K_pad, F32), np.zeros(K_pad, F32)
    gp[:K], bp[:K] = g, b
    xp = np.zeros((M_pad, K_pad), F32)
    xp[:, :K] = x
    y = _fma((xp - mu[:, None]).astype(F32), (r[:, None] * gp[None, :]).astype(F32), bp[None, :])
    return _bf16_bits(y)


def test_prologue_mirror_against_jax_ln():
    """(a) The prologue's arithmetic at the configs' widths (K = 176, 256,
    512): its sums are the standalone kernel's bit for bit (asserted inside
    ``mirror_prologue``), on M = 45 rows (a warp's 16 rows, the last ragged),
    one of them zero (its operand is b); the columns of the last box past K
    stay 0. Against ``_ln`` after the bf16 rounding: bit-equal on all but at
    most 2 elements of each width, each within 2^-8 of its row's largest
    value. Not on every one: XLA sums the row in another order and rounds
    (x - mu) * mul + b twice, where the kernels (this one, and the standalone
    LayerNorm it replaces, bit for bit on the card) take one FMA, so a value
    that lands on a bf16 rounding boundary, or cancels near 0, can round the
    other way (1 element of 7,920 at K = 176 here, none at 256 and 512)."""
    for K in (176, 256, 512):
        rng = np.random.default_rng(K)
        M, M_pad = 45, 48
        x = (rng.standard_normal((M, K)) * 2.0 + 0.3).astype(F32)
        x[7] = 0.0
        x_bits = np.zeros((M_pad, K), np.uint16)
        x_bits[:M] = _bf16_bits(x)
        g = (1.0 + 0.1 * rng.standard_normal(K)).astype(F32)
        b = (0.1 * rng.standard_normal(K)).astype(F32)
        got = mirror_prologue(x_bits, M, g, b, EPS)
        ref = np.asarray(PL._ln(jnp.asarray(_bits_to_f32(x_bits[:M])).astype(jnp.bfloat16), g[None], b[None], EPS)
                         .astype(jnp.float32))
        differ = got[:M, :K] != _bf16_bits(ref)
        assert int(differ.sum()) <= 2, K
        row_scale = np.abs(ref).max(axis=1, keepdims=True)
        assert (np.abs(_bits_to_f32(got[:M, :K]) - ref) <= 2.0 ** -8 * row_scale).all(), K
        np.testing.assert_array_equal(_bits_to_f32(got[7, :K]), _bits_to_f32(_bf16_bits(b)))
        assert not got[:, K:].any()


def test_plain_version_against_jax_ln_then_mm_at_each_site(monkeypatch):
    """(b) ``ln_gemm_plain`` with each call site's epilogue against ``_ln``
    then ``_mm`` (the TPU kernels' own expressions): the macaron FFs' and
    cgMLP's intermediate dense with the GELU (``_gelu_bf16``, and the serving
    profile's ``_gelu_fastest``), the QKV with q_v as the second output
    (``_layer_kernel``'s ``qq + bq_v``), the subsampler's projection (round,
    then the bf16 bias: ``_subsample_kernel``'s tail). Tolerance 2^-6 of the
    output's scale, the GEMM's: the fp32 sums of XLA and PyTorch run in
    another order, and the exact GELU rounds once where XLA's rounds at each
    step, 1-2 bf16 ulps on isolated elements. ``_gelu_fastest`` runs outside
    a Pallas kernel with the correctly rounded reciprocal in place of the
    TPU's approximate one and its Newton step (within one fp32 ulp of it,
    ``csrc/common.cuh::erfc4``)."""
    monkeypatch.setattr(PL, "_recip", lambda v: 1.0 / v)
    rng = np.random.default_rng(7)
    M, D, I = 40, 128, 512
    x = np.array(jnp.asarray(rng.standard_normal((M, D)) * 2.0 + 0.3, jnp.bfloat16).astype(jnp.float32))
    x[5] = 0.0
    g = (1.0 + 0.1 * rng.standard_normal(D)).astype(F32)
    b = (0.1 * rng.standard_normal(D)).astype(F32)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    ln = PL._ln(jnp.asarray(x, jnp.bfloat16), g[None], b[None], EPS)
    tx, tg, tb = torch.from_numpy(x).bfloat16(), torch.from_numpy(g), torch.from_numpy(b)

    def close(got, ref):
        got, ref = got.float().numpy(), np.asarray(jnp.asarray(ref).astype(jnp.float32))
        assert np.abs(got - ref).max() <= 2.0 ** -6 * max(1.0, np.abs(ref).max())

    for act, j_act in (("gelu", PL.gelu_bf16), ("gelu_serving", PL._gelu_fastest)):
        w, bias = bf(rng.standard_normal((D, I)) / np.sqrt(D)), bf(0.1 * rng.standard_normal(I))
        ref = j_act(PL._mm(ln, jnp.asarray(w, jnp.bfloat16), bias[None]))
        close(K1.ln_gemm_plain(tx, tg, tb, EPS, torch.from_numpy(w).bfloat16(), torch.from_numpy(bias), act=act), ref)
    w, bias, bq_v = bf(rng.standard_normal((D, 3 * D)) / np.sqrt(D)), bf(0.1 * rng.standard_normal(3 * D)), \
        bf(0.1 * rng.standard_normal(D))
    qkv, q_v = K1.ln_gemm_plain(tx, tg, tb, EPS, torch.from_numpy(w).bfloat16(), torch.from_numpy(bias),
                                bias2=torch.from_numpy(bq_v))
    close(qkv, PL._mm(ln, jnp.asarray(w, jnp.bfloat16), bias[None]))
    qq = jnp.dot(ln, jnp.asarray(w[:, :D], jnp.bfloat16), preferred_element_type=jnp.float32)
    close(q_v, (qq + bq_v[None]).astype(jnp.bfloat16))
    w, bias = bf(rng.standard_normal((D, D)) / np.sqrt(D)), bf(0.1 * rng.standard_normal(D))
    proj = jnp.dot(ln, jnp.asarray(w, jnp.bfloat16), preferred_element_type=jnp.float32)
    close(K1.ln_gemm_plain(tx, tg, tb, EPS, torch.from_numpy(w).bfloat16(), torch.from_numpy(bias), round_first=True),
          proj.astype(jnp.bfloat16) + jnp.asarray(bias, jnp.bfloat16)[None])


def _admitted_config(D):
    """A config of hidden size D with heads of at most 64 columns, or None."""
    H = next((h for h in range(1, D + 1) if D % h == 0 and D // h <= 64), None)
    cfg = EBranchformerConfig(hidden_size=D, num_attention_heads=H, intermediate_size=4 * D)
    return cfg if fused_encoder_refusal(cfg, torch.bfloat16) is None else None


def test_contract_admits_every_width_the_fused_path_admits():
    """(c) ``ln_gemm_contract`` takes every width that ``fused_encoder_refusal``
    admits (hidden sizes 8 to 512 in steps of 8; the prologue adds no
    refusal) at each call's N, and every shipped config's; K % 8 != 0 and K
    past 512 raise."""
    admitted = []
    for D in range(8, 513, 8):
        cfg = _admitted_config(D)
        if cfg is None:
            continue
        admitted.append(D)
        hw = K1.head_width(cfg.head_size)
        x, gb = torch.zeros(24, D, dtype=torch.bfloat16), torch.zeros(D)
        for N in (cfg.intermediate_size, 3 * cfg.num_attention_heads * hw, D):
            K1.ln_gemm_contract(x, gb, gb.clone(), torch.zeros(D, N, dtype=torch.bfloat16))
    assert admitted[0] == 8 and admitted[-1] == 512 and len(admitted) >= 48
    shipped = set()
    for path in sorted(pathlib.Path(__file__).resolve().parents[1].glob("configs/*.json")):
        d = json.loads(path.read_text())
        cfg = EBranchformerConfig.from_dict(d.get("encoder", d))
        if fused_encoder_refusal(cfg, torch.bfloat16) is None:
            shipped.add(cfg.hidden_size)
            x, gb = torch.zeros(8, cfg.hidden_size, dtype=torch.bfloat16), torch.zeros(cfg.hidden_size)
            K1.ln_gemm_contract(x, gb, gb.clone(), torch.zeros(cfg.hidden_size, cfg.intermediate_size,
                                                               dtype=torch.bfloat16))
    assert shipped == {176, 256, 512}
    for K in (100, 520):  # no multiple of 8; wider than the fused path's widest hidden size
        with pytest.raises(ValueError):
            K1.ln_gemm_contract(torch.zeros(8, K, dtype=torch.bfloat16), torch.zeros(K), torch.zeros(K),
                                torch.zeros(K, 64, dtype=torch.bfloat16))


def test_layer_and_subsampler_call_counts():
    """(d) Through a recording ``ops`` namespace: a layer makes 14 calls, one
    of them ``layer_norm`` (the final LayerNorm) and four ``ln_gemm`` (18 and
    five LayerNorms with the LayerNorm apart); 15 with the CSGU linear; the
    subsampler's tail is ``gemm`` then ``ln_gemm``, no ``layer_norm``. The
    recorded layer's output is the plain layer's."""
    from huggingface_asr_tpu_torch.kernels import subsample as K2

    def recording(ops):
        calls = []

        def wrap(name, fn):
            def call(*args, **kwargs):
                calls.append(name)
                return fn(*args, **kwargs)
            return call
        return types.SimpleNamespace(**{k: wrap(k, v) for k, v in vars(ops).items()}), calls

    for linear in (False, True):
        _, pcfg, _, _, pmodel = make_models(seed=0, csgu_use_linear_after_conv=linear)
        w = K1.fold_layer_weights(pmodel.wav2vec2.encoder.layers[0], pcfg)
        B, T = 2, 16
        x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, T, pcfg.hidden_size))).bfloat16()
        lengths = torch.tensor([16, 9], dtype=torch.int32)
        tables = K1.relpos_kernel_tables(T, pcfg.hidden_size)
        ops, calls = recording(K1.PLAIN_OPS)
        out = K1._layer(x, lengths, w, pcfg, 14, tables, ops, "exact")
        assert len(calls) == 14 + linear and calls.count("layer_norm") == 1 and calls.count("ln_gemm") == 4
        assert calls[-1] == "layer_norm"
        assert torch.equal(out, K1.ebranchformer_layer_plain(x, lengths, w, pcfg, 14, tables))
    sw = K2.fold_subsample_weights(pmodel.wav2vec2, pcfg)
    ops, calls = recording(K2.PLAIN_OPS)
    K2._subsample(torch.zeros(1, 40, 80), sw, pcfg, 16, ops, "exact")
    assert calls == ["conv1", "conv2", "gemm", "ln_gemm"]
