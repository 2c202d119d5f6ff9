"""E-Branchformer encoder layer for inference: weight folds, plain version and
CUDA kernels (counterpart of ``huggingface_asr_tpu/ops/pallas_layer.py``).

The TPU kernel ``_layer_kernel`` keeps one whole layer in VMEM. Hopper has
227 KB of shared memory per block, so here the layer is a short sequence of
kernels (``csrc/``), in ``_layer_kernel``'s order:

  FF1:    ln_gemm(+bias, act) -> gemm(+bias, x + 0.5*out)
  attn:   ln_gemm(QKV; dual bias writes q_u and q_v)
          -> pos_query -> rel_attention -> gemm(out proj)
  cgMLP:  ln_gemm(+bias, exact GELU) -> csgu dwconv -> gemm
          (with ``csgu_use_linear_after_conv``: -> ungated csgu dwconv
          -> gemm(+bias, act, x_r * out: the gate epilogue) -> gemm)
  merge:  merge dwconv -> gemm(+bias, residual + out)
  FF2, then the final layer_norm.

``ln_gemm`` is the GEMM whose A operand is the LayerNorm of its input rows,
normalised inside the kernel (``csrc/gemm_ln.cu``): the four LayerNorms that
only feed a product cost no launch of their own, 14 launches a layer (15 with
the CSGU linear).

Each piece has its plain PyTorch version here. A wrapper sends a CPU tensor
to the plain version and a CUDA tensor to its kernel, and raises on anything
the kernel does not take; nothing falls back. The plain layer
(``ebranchformer_layer_plain``) runs the same sequence on the plain pieces.

Head and q_rot widths: the attention kernels are compiled for heads of 32 and
64 columns and read q_rot / k_std in whole 64-column chunks. The fold pads
each head of another size (44 in the 176-wide configs) with zero columns to
``head_width(dh)`` and the q_rot width D to ``rot_width(D)``, in the weights
and the tables, so that every piece runs on the padded operands as they are.
A zero column adds an exact zero to every fp32 sum: the layer's output is
that of the unpadded layer (the scale keeps the true 1/sqrt(dh)).

Numeric contract (each piece states its own rounding points; they are the
TPU kernel's): bf16 activations between pieces, fp32 accumulation inside,
LayerNorm with flax's fast variance, biases added in fp32 before the bf16
rounding. The numeric profile is an argument, one of ``PROFILES``:

* ``"exact"`` (the default everywhere): GELU is evaluated once in fp32
  (``0.5 x erfc(-x/sqrt 2)``) and rounded once, where the TPU ``bitexact``
  profile replays XLA's intermediate bf16 roundings; the two differ by 1-2
  bf16 ulp on some elements, which is what the tests' bf16 tolerances absorb.
  The attention normaliser is the fp32 sum of the probabilities.
* ``"serving"``: the JAX package's ``set_numeric_profile("serving")``
  (pallas_layer.py:266-289): the model's GELUs (the macaron FFs' when
  ``hidden_act`` is "gelu", channel_proj1's) are the A&S 7.1.27 GELU
  (``act_plain("gelu_serving")``, ``csrc/common.cuh::gelu_serving``), and
  the attention normaliser sums the bf16-rounded probabilities that enter
  P.V (SOFTMAX_Z_MODE "mxu"). The CSGU's activation stays fp32, as in JAX.
"""

from __future__ import annotations

import types
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels.attention import HEAD_WIDTHS, ROT_MAX, head_width
from huggingface_asr_tpu_torch.models.ebranchformer import relpos_tables

ACT_CODES = {"identity": 0, "gelu": 1, "gelu_new": 2, "relu": 3, "swish": 4, "silu": 4}  # the configs' names
# the GEMM epilogue's codes: the configs' activations and the serving profile's GELU, which no config names
GEMM_ACT_CODES = {**ACT_CODES, "gelu_serving": 5}
PROFILES = ("exact", "serving")
NEG_INF = -1.0e9
_SQRT_HALF = 0.7071067811865476
BF16, F32 = torch.bfloat16, torch.float32


def _round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bf16 and back."""
    return x.to(BF16).to(F32)


ROT_CHUNK = 64  # the attention kernels read q_rot and k_std in chunks of this many columns


def rot_width(D: int) -> int:
    """The q_rot / k_std width the attention kernels read: D in whole chunks."""
    return -(-D // ROT_CHUNK) * ROT_CHUNK


def check_profile(profile: str) -> str:
    if profile not in PROFILES:
        raise ValueError(f"numeric profile {profile!r}: one of {PROFILES}")
    return profile


def profile_act(name: str, profile: str) -> str:
    """The activation a GELU of the model runs under ``profile``."""
    return "gelu_serving" if check_profile(profile) == "serving" and name == "gelu" else name


_ERFC4 = (0.078108, 0.000972, 0.230389, 0.278393)  # A&S 7.1.27's a4 .. a1


def erfc4(u: torch.Tensor) -> torch.Tensor:
    """``csrc/common.cuh::erfc4`` on fp32 values, one IEEE operation at a
    time in the same order (PyTorch fuses no multiply-add here), so that the
    kernels' bits are the same: A&S 7.1.27 with the JAX serving profile's
    clamps (``pallas_layer.py::_erfc_rational4``)."""
    ax = u.abs()
    p = ax * _ERFC4[0] + _ERFC4[1]
    for a in _ERFC4[2:]:
        p = p * ax + a
    p = torch.clamp(p * ax + 1.0, max=1.0e9)
    p2 = p * p
    inv = torch.where(ax > 10.06, 0.0, 1.0 / (p2 * p2))
    return torch.where(u >= 0, inv, 2.0 - inv)


def act_plain(name: str, x: torch.Tensor) -> torch.Tensor:
    """Activations in fp32, as ``csrc/common.cuh::apply_act``."""
    if name == "gelu":
        return 0.5 * x * torch.special.erfc(-x * _SQRT_HALF)
    if name == "gelu_serving":
        return (0.5 * x) * erfc4(x * -_SQRT_HALF)
    if name == "gelu_new":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    if name in ("swish", "silu"):
        return F.silu(x)
    if name == "identity":
        return x
    raise ValueError(f"unsupported activation {name!r}")


# ---------------------------------------------------------------------------
# LayerNorm


def layer_norm_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """Row LayerNorm with flax's fast variance (E[x^2] - mu^2, clipped at 0),
    ``(x - mu) * (rsqrt(var + eps) * g) + b`` in fp32, one bf16 rounding."""
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return ((xf - mu) * (torch.rsqrt(var + eps) * g) + b).to(BF16)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """``layer_norm_plain`` on (M, D) bf16 rows; CUDA tensors run ``csrc/layer.cu``."""
    if not _build.on_cuda(x, g, b):
        return layer_norm_plain(x, g, b, eps)
    M, D = x.shape
    _build.check(x, "x", BF16, contiguous=False)
    if x.stride(1) != 1:
        raise ValueError("layer_norm: rows must be contiguous")
    _build.check(g, "g", F32, (D,))
    _build.check(b, "b", F32, (D,))
    y = torch.empty(M, D, dtype=BF16, device=x.device)
    _build.launch("asr_layernorm_bf16", "ppppiiiif", x.data_ptr(), g.data_ptr(), b.data_ptr(),
                  y.data_ptr(), M, D, x.stride(0), D, float(eps))
    return y


# ---------------------------------------------------------------------------
# GEMM with fused epilogue


def gemm_plain(a, w, bias=None, *, act="identity", residual=None, alpha=1.0, bias2=None,
               round_first=False, out=None, gate=None):
    """``bf16(epilogue(a @ w))`` with fp32 accumulation; see ``csrc/gemm.cuh``
    for the rounding points. With ``bias2`` returns ``(out, out2)`` where
    ``out2 = bf16(acc[:, :n2] + bias2)``. ``gate`` (M, N) bf16, in place of a
    residual: the result is ``bf16(gate * v)``."""
    acc = a.to(F32) @ w.to(F32)
    out2 = None
    if bias2 is not None:
        out2 = (acc[:, : bias2.shape[0]] + bias2).to(BF16)
    b = bias if bias is not None else 0.0
    v = _round(_round(acc) + b) if round_first else _round(acc + b)
    if act != "identity":
        v = _round(act_plain(act, v))
    if residual is not None:
        v = residual.to(F32) + alpha * v
    elif gate is not None:
        v = gate.to(F32) * v
    v = v.to(BF16)
    if out is not None:
        out.copy_(v)
        v = out
    return (v, out2) if bias2 is not None else v


def _check_rows(t: torch.Tensor, name: str, shape) -> int:
    """2-D bf16 CUDA view with unit column stride and a 16-byte-aligned row
    stride; returns the row stride."""
    _build.check(t, name, BF16, shape, contiguous=False)
    if t.stride(1) != 1 or t.stride(0) % 8:
        raise ValueError(f"{name}: needs unit column stride and a row stride divisible by 8")
    return t.stride(0)


def gemm_contract(a, w, out=None, residual=None, bias2=None) -> None:
    """Raise unless the GEMM kernel takes these shapes, strides and base
    addresses (whatever device the tensors lie on): N % 8 == 0, K % 8 == 0
    (rows of 16 bytes; a last tile that is partly past N or K is the kernel's
    edge tile); ``a`` (M, K), ``out`` and ``residual`` (M, N) with unit column
    stride, a row stride divisible by 8 and a 16-byte aligned base, which is
    what the kernel's TMA boxes and 16-byte stores need; ``len(bias2)`` a
    multiple of 8, at most N."""
    M, K = a.shape
    N = w.shape[1]
    if N % 8 or K % 8:
        raise ValueError(f"gemm kernel needs N % 8 == 0 and K % 8 == 0, got N={N}, K={K}")
    for name, t, shape in (("a", a, (M, K)), ("out", out, (M, N)), ("residual", residual, (M, N))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.stride(1) != 1 or t.stride(0) % 8:
            raise ValueError(f"{name}: needs unit column stride and a row stride divisible by 8")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer is not 16-byte aligned")
    if bias2 is not None and (bias2.shape[0] % 8 or bias2.shape[0] > N):
        raise ValueError(f"gemm kernel needs len(bias2) % 8 == 0 and <= N, got {bias2.shape[0]}")


def gemm(a, w, bias=None, *, act="identity", residual=None, alpha=1.0, bias2=None,
         round_first=False, out=None, gate=None):
    """``gemm_plain``; CUDA tensors run the wgmma + TMA GEMM of ``csrc/gemm.cuh``
    (two tile shapes, chosen there from M and N; the epilogue runs on the
    accumulator fragment). a: (M, K) bf16, a view with a row stride is fine;
    w: (K, N) bf16; bias/bias2: fp32; ``out`` may be a column slice of a wider
    buffer, whose other columns and rows are left untouched. ``gate`` (a view
    with a row stride is fine) runs the gate epilogue, ``asr_gemm_gate_bf16``
    (counted under that name), and takes neither ``residual`` nor ``bias2``.
    ``act="gelu_serving"`` (the serving profile's GELU) is counted under
    ``asr_gemm_gelu_serving``. What the kernel takes is ``gemm_contract``'s to
    say; anything else raises."""
    tensors = [t for t in (a, w, bias, residual, bias2, out, gate) if t is not None]
    if not _build.on_cuda(*tensors):
        return gemm_plain(a, w, bias, act=act, residual=residual, alpha=alpha, bias2=bias2,
                          round_first=round_first, out=out, gate=gate)
    if gate is not None and (residual is not None or bias2 is not None or round_first):
        raise ValueError("gemm: the gate epilogue takes no residual, bias2 or round_first")
    M, K = a.shape
    N = w.shape[1]
    if out is None:
        out = torch.empty(M, N, dtype=BF16, device=a.device)
    gemm_contract(a, w, out, residual if gate is None else gate, bias2)  # shapes, strides, base addresses
    for name, t in (("a", a), ("out", out), ("residual", residual), ("gate", gate)):
        if t is not None and t.dtype != BF16:
            raise ValueError(f"{name}: expected {BF16}, got {t.dtype}")
    _build.check(w, "w", BF16, (K, N))
    if bias is not None:
        _build.check(bias, "bias", F32, (N,))
    lda, ldo = a.stride(0), out.stride(0)
    if gate is not None:
        _build.launch("asr_gemm_gate_bf16", "pppppiiiiiiii", a.data_ptr(), w.data_ptr(),
                      None if bias is None else bias.data_ptr(), out.data_ptr(), gate.data_ptr(), M, N, K,
                      lda, N, ldo, gate.stride(0), GEMM_ACT_CODES[act])
        return out
    ldr = residual.stride(0) if residual is not None else 0
    out2, n2, ldo2 = None, 0, 0
    if bias2 is not None:
        n2 = bias2.shape[0]
        _build.check(bias2, "bias2", F32, (n2,))
        out2 = torch.empty(M, n2, dtype=BF16, device=a.device)
        ldo2 = n2
    ptr = lambda t: t.data_ptr() if t is not None else None
    _build.launch("asr_gemm_bf16", "pppppppiiiiiiiiiiif", a.data_ptr(), w.data_ptr(), ptr(bias),
                  ptr(bias2), out.data_ptr(), ptr(out2), ptr(residual), M, N, K, lda, N, ldo,
                  ldo2, ldr, n2, GEMM_ACT_CODES[act], int(round_first), float(alpha),
                  label="asr_gemm_gelu_serving" if act == "gelu_serving" else None)
    return (out, out2) if bias2 is not None else out


# ---------------------------------------------------------------------------
# GEMM with a LayerNorm prologue


def ln_gemm_plain(x, g, b, eps, w, bias=None, *, act="identity", bias2=None, round_first=False, out=None):
    """``gemm_plain(layer_norm_plain(x, g, b, eps), w, ...)``: the GEMM of the
    bf16 LayerNorm of the rows of ``x`` (the operand rounded once, as the TPU
    kernel's ``_ln`` feeds its ``_mm``)."""
    return gemm_plain(layer_norm_plain(x, g, b, eps), w, bias, act=act, bias2=bias2, round_first=round_first,
                      out=out)


LN_GEMM_MAX_K = 512  # the large tile keeps a 128-row tile of normalised rows, K wide, in shared memory


def ln_gemm_contract(x, g, b, w, out=None, bias2=None) -> None:
    """Raise unless ``csrc/gemm_ln.cu`` takes these operands (whatever device
    they lie on): what ``gemm_contract`` asks of ``x`` as the A operand (K a
    multiple of 8: the product's edge tiles), K at most ``LN_GEMM_MAX_K`` (the
    widest hidden size the fused path admits), and ``g``, ``b`` (K,) fp32,
    contiguous and 16-byte aligned (read 8 columns at a time)."""
    gemm_contract(x, w, out, None, bias2)
    K = x.shape[1]
    if K > LN_GEMM_MAX_K:
        raise ValueError(f"ln_gemm kernel takes K <= {LN_GEMM_MAX_K}, got {K}")
    for name, t in (("g", g), ("b", b)):
        if t.dtype != F32 or tuple(t.shape) != (K,) or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned ({K},) float32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")


def ln_gemm(x, g, b, eps, w, bias=None, *, act="identity", bias2=None, round_first=False, out=None):
    """``ln_gemm_plain``; CUDA tensors run ``csrc/gemm_ln.cu`` (the GEMM of
    ``csrc/gemm.cuh`` with the LayerNorm in its operand prologue: one launch,
    the normalised rows never written; bit-equal to ``layer_norm`` followed by
    ``gemm``). Takes ``gemm``'s epilogues but the residual and the gate:
    ``act``, ``bias2`` (returns ``(out, out2)``), ``round_first``, ``out`` (a
    column slice is fine). ``act="gelu_serving"`` is counted under
    ``asr_gemm_ln_gelu_serving``. What the kernel takes is
    ``ln_gemm_contract``'s to say; anything else raises."""
    tensors = [t for t in (x, g, b, w, bias, bias2, out) if t is not None]
    if not _build.on_cuda(*tensors):
        return ln_gemm_plain(x, g, b, eps, w, bias, act=act, bias2=bias2, round_first=round_first, out=out)
    M, K = x.shape
    N = w.shape[1]
    if out is None:
        out = torch.empty(M, N, dtype=BF16, device=x.device)
    ln_gemm_contract(x, g, b, w, out, bias2)
    for name, t in (("x", x), ("out", out)):
        if t.dtype != BF16:
            raise ValueError(f"{name}: expected {BF16}, got {t.dtype}")
    _build.check(w, "w", BF16, (K, N))
    if bias is not None:
        _build.check(bias, "bias", F32, (N,))
    out2, n2, ldo2 = None, 0, 0
    if bias2 is not None:
        n2 = bias2.shape[0]
        _build.check(bias2, "bias2", F32, (n2,))
        out2 = torch.empty(M, n2, dtype=BF16, device=x.device)
        ldo2 = n2
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    _build.launch("asr_gemm_ln_bf16", "pppfppppp" + "i" * 10, x.data_ptr(), g.data_ptr(), b.data_ptr(),
                  float(eps), w.data_ptr(), ptr(bias), ptr(bias2), out.data_ptr(), ptr(out2), M, N, K,
                  x.stride(0), N, out.stride(0), ldo2, n2, GEMM_ACT_CODES[act], int(round_first),
                  label="asr_gemm_ln_gelu_serving" if act == "gelu_serving" else None)
    return (out, out2) if bias2 is not None else out


# ---------------------------------------------------------------------------
# Positional query


def _fragment_order(n: int) -> torch.Tensor:
    """Row order of ``pos_weights`` within each whole chunk of 32 columns:
    row 8j + 2q + e holds column 8q + 2j + e (an involution), so that the
    lane of a product's accumulator fragment that holds fragment columns
    8j + 2q + e, j < 4, holds output columns 8q .. 8q + 7 in order. A tail of
    fewer than 32 columns keeps its order."""
    r = torch.arange(n)
    c = r % 32
    swapped = r - c + 8 * ((c % 8) // 2) + 2 * (c // 8) + c % 2
    return torch.where(r < n - n % 32, swapped, r)


def pos_weights(wp_e: torch.Tensor, wp_o: torch.Tensor) -> torch.Tensor:
    """The positional projection as ``pos_query`` reads it: ``[wp_e | wp_o]``
    of each head transposed, (H, dh, D/2) twice -> (H, D, dh), so that a row
    holds the dh weights of one output column (K-major, the layout a
    tensor-core product reads): rows < D/2 wp_e's columns, the rest wp_o's,
    each half in ``_fragment_order``."""
    half = wp_e.shape[-1]
    order = _fragment_order(half)
    return torch.cat([wp_e[..., order], wp_o[..., order]], dim=-1).transpose(1, 2).contiguous()


def split_pos_weights(wp: torch.Tensor):
    """(wp_e, wp_o), each (H, dh, D/2), from ``pos_weights``' layout."""
    w = wp.transpose(1, 2)
    half = w.shape[-1] // 2
    order = _fragment_order(half).to(wp.device)  # an involution: its own inverse
    return w[..., :half][..., order], w[..., half:][..., order]


def pos_query_plain(q_v, wp, rot_cos, rot_sin, T: int) -> torch.Tensor:
    """q_rot[m, h] = [cos*ce + sin*co, cos*co - sin*ce] with ce|co = q_v_h @
    [wp_e | wp_o][h] (fp32 accumulation), cos/sin at frame m % T. q_v: (M, H*dh)
    bf16; wp: (H, D, dh) bf16 (``pos_weights``); rot tables (T, D/2) bf16. ->
    (M, H, D) bf16. With the padded fold (zero rows and columns in wp, zero
    columns in the tables) the pad columns of q_rot come out as exact zeros."""
    M = q_v.shape[0]
    wp_e, wp_o = split_pos_weights(wp)
    H, dh, half = wp_e.shape
    qv = q_v.to(F32).reshape(M, H, dh)
    ce = torch.einsum("mhd,hdj->mhj", qv, wp_e.to(F32))
    co = torch.einsum("mhd,hdj->mhj", qv, wp_o.to(F32))
    t = torch.arange(M, device=q_v.device) % T
    c = rot_cos.to(F32)[t][:, None, :]
    s = rot_sin.to(F32)[t][:, None, :]
    return torch.cat([c * ce + s * co, c * co - s * ce], dim=-1).to(BF16)


POS_QUERY_MAX_D = 512  # the widest q_rot whose weight rows the kernel holds in shared memory


def pos_query(q_v, wp, rot_cos, rot_sin, T: int) -> torch.Tensor:
    """``pos_query_plain``; CUDA tensors run ``csrc/layer.cu::pos_query_kernel``
    (head widths 32 and 64, D a multiple of 64 up to 512: what the fold gives)."""
    if not _build.on_cuda(q_v, wp, rot_cos, rot_sin):
        return pos_query_plain(q_v, wp, rot_cos, rot_sin, T)
    M = q_v.shape[0]
    H, D, dh = wp.shape
    if dh not in HEAD_WIDTHS or D % ROT_CHUNK or D > POS_QUERY_MAX_D:
        raise ValueError(f"pos_query: the kernel takes head widths {HEAD_WIDTHS} and q_rot widths that are "
                         f"multiples of {ROT_CHUNK} up to {POS_QUERY_MAX_D}, got {dh} and {D}")
    ldq = _check_rows(q_v, "q_v", (M, H * dh))
    _build.check(wp, "wp", BF16, (H, D, dh))
    _build.check(rot_cos, "rot_cos", BF16, (T, D // 2))
    _build.check(rot_sin, "rot_sin", BF16, (T, D // 2))
    q_rot = torch.empty(M, H, D, dtype=BF16, device=q_v.device)
    if M:
        _build.launch("asr_pos_query", "pppppiiiiii", q_v.data_ptr(), wp.data_ptr(), rot_cos.data_ptr(),
                      rot_sin.data_ptr(), q_rot.data_ptr(), M, T, H, dh, D, ldq)
    return q_rot


# ---------------------------------------------------------------------------
# Relative-position attention, factored form (the interface of the training
# attention's forward, without dropout)


def rel_attention_plain(q_u, k, v, q_rot, k_std, lengths, profile: str = "exact") -> torch.Tensor:
    """softmax2(q_u.k + q_rot.k_std + mask) @ v, normalised after P.V.

    q_u, k, v: (B, T, H, dh) bf16 (views allowed); q_rot: (B, T, H, D) bf16;
    k_std: (T, D) bf16; lengths: (B,) int32. Scores are log2-scaled (the
    scales are folded into the query weights); keys at or past an
    utterance's length get the finite -1e9. The normaliser is the fp32 sum
    of the probabilities, or under ``profile="serving"`` the sum of the same
    bf16-rounded probabilities that enter P.V. -> (B, T, H, dh) bf16."""
    B, T, H, dh = q_u.shape
    s = (torch.einsum("bthd,bshd->bhts", q_u.to(F32), k.to(F32))
         + torch.einsum("bthD,sD->bhts", q_rot.to(F32), k_std.to(F32)))
    col = torch.arange(T, device=q_u.device)
    s = s + torch.where(col[None, :] < lengths[:, None].to(col.dtype), 0.0, NEG_INF)[:, None, None, :]
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = _round(e)
    z = (p if check_profile(profile) == "serving" else e).sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bhtd", p, v.to(F32)) * (1.0 / z)
    return o.permute(0, 2, 1, 3).to(BF16).contiguous()


def rel_attention_width_ok(D: int) -> bool:
    """The q_rot / k_std widths ``csrc/rel_attention.cu`` takes: whole 64-column
    chunks, at most ``ROT_MAX``: the query tile within a block's shared memory
    beside three key stages (k_std's chunks in them up to 256, in a ring of
    their own past that), at either head width."""
    return D % ROT_CHUNK == 0 and ROT_CHUNK <= D <= ROT_MAX


def rel_attention(q_u, k, v, q_rot, k_std, lengths, profile: str = "exact") -> torch.Tensor:
    """``rel_attention_plain``; CUDA tensors run ``csrc/rel_attention.cu``
    (wgmma out of TMA-filled shared memory, one walk with an online softmax).
    The kernel takes a head width of 32 or 64 and a q_rot width D that is a
    multiple of 64, at most 512 (the layer passes the padded operands of
    ``fold_layer_weights``); q_u, k, v may be column views of one (B*T, 3*H*dh)
    buffer, which the kernel's tensor maps read in place. ``profile="serving"``
    runs the kernel's serving normaliser, counted as ``asr_rel_attention_serving``."""
    serving = check_profile(profile) == "serving"
    if not _build.on_cuda(q_u, k, v, q_rot, k_std, lengths):
        return rel_attention_plain(q_u, k, v, q_rot, k_std, lengths, profile)
    B, T, H, dh = q_u.shape
    D = q_rot.shape[-1]
    if dh not in HEAD_WIDTHS:
        raise ValueError(f"rel_attention kernel takes head widths {HEAD_WIDTHS}, got {dh}")
    if not rel_attention_width_ok(D):
        raise ValueError(f"rel_attention kernel needs D % 64 == 0 and D <= {ROT_MAX}, got {D}")
    ld = q_u.stride(1)
    for name, t in (("q_u", q_u), ("k", k), ("v", v)):
        _build.check(t, name, BF16, (B, T, H, dh), contiguous=False)
        if t.stride() != (T * ld, ld, dh, 1) or ld % 8:
            raise ValueError(f"{name}: expected (B, T, H, dh) rows with one shared row stride")
    _build.check(q_rot, "q_rot", BF16, (B, T, H, D))
    _build.check(k_std, "k_std", BF16, (T, D))
    _build.check(lengths, "lengths", torch.int32, (B,))
    out = torch.empty(B, T, H, dh, dtype=BF16, device=q_u.device)
    _build.launch("asr_rel_attention", "pppppppiiiiiiii", q_u.data_ptr(), k.data_ptr(),
                  v.data_ptr(), q_rot.data_ptr(), k_std.data_ptr(), lengths.data_ptr(),
                  out.data_ptr(), B, T, H, dh, D, ld, H * dh, int(serving),
                  label="asr_rel_attention_serving" if serving else None)
    return out


# ---------------------------------------------------------------------------
# Depthwise convs (CSGU and merge)


def _dwconv_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, t_valid: int) -> torch.Tensor:
    """fp32 depthwise conv along T of (B, T, C) values, rows >= t_valid read as 0."""
    B, T, C = x.shape
    K = w.shape[0]
    P = (K - 1) // 2
    x = torch.where(torch.arange(T, device=x.device)[None, :, None] < t_valid, x, 0.0)
    xp = F.pad(x, (0, 0, P, P))
    acc = bias.expand(B, T, C)
    wf = w.to(F32)
    for j in range(K):
        acc = acc + xp[:, j: j + T] * wf[j]
    return acc


def csgu_plain(l, ln_g, ln_b, w, bias, B: int, T: int, t_valid: int, act: str, eps: float):
    """CSGU: gated = bf16(l[:, :C] * bf16(act(dwconv(LN(l[:, C:]))))).
    l: (B*T, 2C) bf16 -> (B*T, C) bf16."""
    C = l.shape[1] // 2
    g = layer_norm_plain(l[:, C:], ln_g, ln_b, eps).to(F32).reshape(B, T, C)
    gate = _round(act_plain(act, _dwconv_plain(g, w, bias, t_valid)))
    return (l[:, :C].to(F32) * gate.reshape(B * T, C)).to(BF16)


def csgu_conv_plain(l, ln_g, ln_b, w, bias, B: int, T: int, t_valid: int, eps: float):
    """The ungated CSGU conv of a model with ``csgu_use_linear_after_conv``:
    bf16(dwconv(LN(l[:, C:]))), no activation and no gate (the CSGU linear's
    gate epilogue, ``gemm(..., gate=l[:, :C])``, finishes it). l: (B*T, 2C)
    bf16 -> (B*T, C) bf16."""
    C = l.shape[1] // 2
    g = layer_norm_plain(l[:, C:], ln_g, ln_b, eps).to(F32).reshape(B, T, C)
    return _dwconv_plain(g, w, bias, t_valid).reshape(B * T, C).to(BF16)


def merge_conv_plain(x, w, bias, B: int, T: int, t_valid: int):
    """merged + bf16(dwconv(merged)), rounded to bf16. x: (B*T, C) bf16."""
    C = x.shape[1]
    acc = _dwconv_plain(x.to(F32).reshape(B, T, C), w, bias, t_valid)
    return (x.to(F32) + _round(acc).reshape(B * T, C)).to(BF16)


DWCONV_MAX_K = 33
DWCONV_MAX_C = {0: 1024, 1: 1024}  # CSGU, merge: two stages of a 16-row tile of 128-channel slices in 227 KB
DWCONV_CSGU_ROW_C = 768  # CSGU tiles of whole rows up to here; past it 128-channel slices


def dwconv_channels_ok(mode: int, C: int) -> bool:
    """Whether the depthwise conv kernel takes C channels in ``mode`` (0 CSGU,
    1 merge): a multiple of 8, at most ``DWCONV_MAX_C[mode]``, and past
    ``DWCONV_CSGU_ROW_C`` (CSGU) a whole number of 128-channel slices."""
    return C % 8 == 0 and 0 < C <= DWCONV_MAX_C[mode] and (mode != 0 or C <= DWCONV_CSGU_ROW_C or C % 128 == 0)


def dwconv_contract(mode: int, x, w, bias, B: int, T: int, t_valid: int, ln_g=None, ln_b=None) -> int:
    """Raise unless ``csrc/dwconv.cu`` takes these operands (whatever device
    they lie on); return C. mode 0 (CSGU) and 2 (CSGU, ungated): x is (B*T,
    2C) ``[x_r | x_g]``; mode 1 (merge): x is (B*T, C). x may be a row view: unit column stride, a
    row stride divisible by 8 and a 16-byte aligned base, which the kernel's
    TMA maps need; C a multiple of 8, at most 1024, so that two stages of a
    tile fit in shared memory (CSGU past 768 in 128-channel slices: C a
    multiple of 128 there); w (K, C) bf16 with
    K odd, at most 33 (the TPU kernel's ``PAD_ALLOC``); bias, ln_g, ln_b (C,)
    fp32, each contiguous; 0 <= t_valid."""
    csgu = mode != 1
    width = x.shape[1] if x.ndim == 2 else -1
    C = width // 2 if csgu else width
    if x.ndim != 2 or x.shape[0] != B * T or C <= 0 or width != (2 * C if csgu else C):
        raise ValueError(f"x: expected ({B * T}, {'2C' if csgu else 'C'}) rows, got {tuple(x.shape)}")
    if not dwconv_channels_ok(int(not csgu), C):
        raise ValueError(f"depthwise conv kernel needs C % 8 == 0 and C <= {DWCONV_MAX_C[int(not csgu)]} (CSGU "
                         f"past {DWCONV_CSGU_ROW_C}: whole 128-channel slices), got C={C}")
    if x.stride(1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError("x: needs unit column stride, a row stride divisible by 8 and a 16-byte aligned base")
    K = w.shape[0] if w.ndim == 2 else 0
    if K % 2 == 0 or K > DWCONV_MAX_K:
        raise ValueError(f"depthwise conv kernel needs an odd kernel size of at most {DWCONV_MAX_K}, got {K}")
    if t_valid < 0:
        raise ValueError(f"t_valid must be >= 0, got {t_valid}")
    params = [("x", x, BF16, None), ("w", w, BF16, (K, C)), ("bias", bias, F32, (C,))]
    if csgu:
        params += [("ln_g", ln_g, F32, (C,)), ("ln_b", ln_b, F32, (C,))]
    for name, t, dtype, shape in params:
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if shape is not None and (tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned {shape} tensor, got {tuple(t.shape)}")
    return C


def _dwconv(mode, x, ln_g, ln_b, w, bias, B, T, t_valid, act, eps, label, out=None):
    """Launch ``asr_dwconv``; ``out`` (B*T, C) may be a view of a larger
    buffer, of which only these rows are written."""
    C = dwconv_contract(mode, x, w, bias, B, T, t_valid, ln_g, ln_b)
    for name, t in (("x", x), ("w", w), ("bias", bias), ("ln_g", ln_g), ("ln_b", ln_b)):
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if out is None:
        out = torch.empty(B * T, C, dtype=BF16, device=x.device)
    _build.check(out, "out", BF16, (B * T, C))
    # CSGU in channel slices: each row's (mean, 1 / std) from the kernel's first pass
    stats = torch.empty(B * T, 2, dtype=F32, device=x.device) if mode != 1 and C > DWCONV_CSGU_ROW_C else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    _build.launch("asr_dwconv", "pppppppiiiiiiiif", x.data_ptr(), ptr(ln_g), ptr(ln_b),
                  w.data_ptr(), bias.data_ptr(), out.data_ptr(), ptr(stats), B, T, t_valid, C, w.shape[0],
                  x.stride(0), mode, ACT_CODES[act], float(eps), label=label)
    return out


def csgu(l, ln_g, ln_b, w, bias, B: int, T: int, t_valid: int, act: str, eps: float):
    """``csgu_plain``; CUDA tensors run ``csrc/dwconv_csgu.cu`` (``l`` may be a
    row view; what the kernel takes is ``dwconv_contract``'s to say)."""
    if not _build.on_cuda(l, ln_g, ln_b, w, bias):
        return csgu_plain(l, ln_g, ln_b, w, bias, B, T, t_valid, act, eps)
    return _dwconv(0, l, ln_g, ln_b, w, bias, B, T, t_valid, act, eps, "dwconv_csgu")


def csgu_conv(l, ln_g, ln_b, w, bias, B: int, T: int, t_valid: int, eps: float):
    """``csgu_conv_plain``; CUDA tensors run ``csrc/dwconv_csgu.cu``'s ungated
    kernel (mode 2 of ``asr_dwconv``, counted as ``dwconv_csgu_conv``), which
    takes what ``csgu`` takes."""
    if not _build.on_cuda(l, ln_g, ln_b, w, bias):
        return csgu_conv_plain(l, ln_g, ln_b, w, bias, B, T, t_valid, eps)
    return _dwconv(2, l, ln_g, ln_b, w, bias, B, T, t_valid, "identity", eps, "dwconv_csgu_conv")


def merge_conv(x, w, bias, B: int, T: int, t_valid: int):
    """``merge_conv_plain``; CUDA tensors run ``csrc/dwconv.cu``'s merge kernel."""
    if not _build.on_cuda(x, w, bias):
        return merge_conv_plain(x, w, bias, B, T, t_valid)
    return _dwconv(1, x, None, None, w, bias, B, T, t_valid, "identity", 0.0, "dwconv_merge")


# ---------------------------------------------------------------------------
# Weight folds


def relpos_kernel_tables(T: int, D: int, device=None) -> Dict[str, torch.Tensor]:
    """bf16 rotation tables (T, D_rot/2) and the ascending sinusoid table
    ``k_std = [sin | cos]`` (T, D_rot), built in float64 like the JAX fold, at
    the frequencies of D; with ``D_rot = rot_width(D)`` > D each half ends in
    zero columns (the pad columns of q_rot meet zeros of k_std)."""
    pad = (rot_width(D) - D) // 2
    cos, sin = (F.pad(t, (0, pad)).to(BF16) for t in relpos_tables(T, D))
    return {
        "rot_cos": cos.to(device),
        "rot_sin": sin.to(device),
        "k_std": torch.cat([sin, cos], dim=-1).to(device),
    }


@torch.no_grad()
def fold_layer_weights(layer, cfg, device=None) -> Dict[str, torch.Tensor]:
    """Fold one ``EBranchformerEncoderLayer``'s float32 parameters into kernel
    operands, as ``pallas_layer.py::fold_layer_weights`` does:

    * matrices as (in, out) bf16; dense biases rounded to bf16, kept fp32;
      LayerNorm parameters fp32;
    * 1/sqrt(dh) * log2(e) folded into W_q and both query biases
      (the attention softmax runs on exp2), bias_u / bias_v added into the
      query bias: ``b_qkv = [bq_u | bk | bv]`` and ``bq_v`` fp32;
    * W_q, W_k, W_v concatenated into one (D, 3D) matrix;
    * the positional projection kept low rank per head, split into even
      (sin) and odd (cos) sinusoid channels, the sin half negated: (H, dh,
      D/2) twice, stored as ``pos_weights`` lays them out, (H, D, dh);
    * depthwise conv kernels as (K, C) bf16, their biases fp32;
    * with ``csgu_use_linear_after_conv`` the CSGU linear as ``csgu_lin_w``
      (C, C) bf16 and ``csgu_lin_b`` (rounded to bf16, as the TPU fold keeps it).

    Each head is padded with zero columns to ``head_width(dh)`` (HW) in W_q,
    W_k, W_v and their biases, with zero rows in W_out and in the positional
    projection, whose D/2 columns are padded to ``rot_width(D) / 2``; the
    scale is that of the true dh. So ``w_qkv`` is (D, 3*H*HW), ``bq_v``
    (H*HW,), ``wo`` (H*HW, D) and ``wp`` (H, rot_width(D), HW); nothing
    changes where dh is 32 and D a multiple of 64.
    """
    D, H = cfg.hidden_size, cfg.num_attention_heads
    dh = D // H
    hw, pad_rot = head_width(dh), (rot_width(D) - D) // 2
    if hw is None:
        raise ValueError(f"head size {dh}: the attention kernels take head sizes of at most {HEAD_WIDTHS[-1]}")
    inv = np.float32(np.log2(np.e) / np.sqrt(dh))

    def heads(t, dim):
        """Pad each head's dh entries along ``dim`` of ``t`` to hw with zeros."""
        t = t.unflatten(dim, (H, dh))
        return F.pad(t, [0, 0] * (t.ndim - dim - 2) + [0, hw - dh]).flatten(dim, dim + 1)

    def mat(lin):
        return lin.weight.detach().to(F32).t().contiguous().to(BF16)

    def vec(lin):
        return _round(lin.bias.detach().to(F32))

    def ln(m):
        return m.weight.detach().to(F32), m.bias.detach().to(F32)

    def dw(conv):
        return (conv.weight.detach().to(F32)[:, 0, :].t().contiguous().to(BF16),
                conv.bias.detach().to(F32))

    att = layer.self_attn
    wq = att.linear_q.weight.detach().to(F32).t() * inv
    bq = att.linear_q.bias.detach().to(F32).reshape(H, dh)
    bq_u = ((bq + att.pos_bias_u.detach().to(F32)).reshape(D) * inv)
    bq_v = ((bq + att.pos_bias_v.detach().to(F32)).reshape(D) * inv)
    wp_t = att.linear_pos.weight.detach().to(F32).t().reshape(D, H, dh).permute(1, 2, 0)
    low_rank = lambda t: F.pad(t, (0, pad_rot, 0, hw - dh)).to(BF16)  # noqa: E731
    w = {
        "w_qkv": torch.cat([heads(t, 1) for t in (wq.to(BF16), mat(att.linear_k), mat(att.linear_v))], dim=1),
        "b_qkv": torch.cat([heads(t, 0) for t in (bq_u, vec(att.linear_k), vec(att.linear_v))]),
        "bq_v": heads(bq_v, 0),
        "wo": heads(mat(att.linear_out), 0), "bo": vec(att.linear_out),
        "wp": pos_weights(low_rank(-wp_t[:, :, 0::2]), low_rank(wp_t[:, :, 1::2])),
    }
    w["attn_ln_g"], w["attn_ln_b"] = ln(layer.self_attn_layer_norm)
    for ff in ("ff1", "ff2"):
        norm, mlp = getattr(layer, ff)
        w[f"{ff}_ln_g"], w[f"{ff}_ln_b"] = ln(norm)
        w[f"{ff}_wi"], w[f"{ff}_bi"] = mat(mlp.intermediate_dense), vec(mlp.intermediate_dense)
        w[f"{ff}_wo"], w[f"{ff}_bo"] = mat(mlp.output_dense), vec(mlp.output_dense)
    cg = layer.cgMLP
    w["cg_ln_g"], w["cg_ln_b"] = ln(layer.cgMLP_layer_norm)
    w["cg_w1"], w["cg_b1"] = mat(cg.channel_proj1[0]), vec(cg.channel_proj1[0])
    w["csgu_ln_g"], w["csgu_ln_b"] = ln(cg.csgu.norm)
    w["csgu_dw"], w["csgu_dw_b"] = dw(cg.csgu.conv)
    if cfg.csgu_use_linear_after_conv:
        w["csgu_lin_w"], w["csgu_lin_b"] = mat(cg.csgu.linear), vec(cg.csgu.linear)
    w["cg_w2"], w["cg_b2"] = mat(cg.channel_proj2), vec(cg.channel_proj2)
    w["merge_dw"], w["merge_dw_b"] = dw(layer.depthwise_conv_fusion)
    w["merge_w"], w["merge_b"] = mat(layer.merge_proj), vec(layer.merge_proj)
    w["final_ln_g"], w["final_ln_b"] = ln(layer.final_layer_norm)
    return {k: v.contiguous().to(device) for k, v in w.items()}


# ---------------------------------------------------------------------------
# The layer

PLAIN_OPS = types.SimpleNamespace(
    layer_norm=layer_norm_plain, gemm=gemm_plain, ln_gemm=ln_gemm_plain, pos_query=pos_query_plain,
    rel_attention=rel_attention_plain, csgu=csgu_plain, csgu_conv=csgu_conv_plain, merge_conv=merge_conv_plain,
)
KERNEL_OPS = types.SimpleNamespace(
    layer_norm=layer_norm, gemm=gemm, ln_gemm=ln_gemm, pos_query=pos_query,
    rel_attention=rel_attention, csgu=csgu, csgu_conv=csgu_conv, merge_conv=merge_conv,
)


def _layer(x, lengths, w, cfg, t_valid, tables, ops, profile):
    B, T, D = x.shape
    H = cfg.num_attention_heads
    M, eps, act = B * T, cfg.layer_norm_eps, profile_act(cfg.hidden_act, profile)
    hw, d_rot = w["wp"].shape[2], tables["k_std"].shape[1]  # the fold's padded widths
    xf = x.reshape(M, D)

    # macaron FF1: x += 0.5 * FF(LN(x))
    h = ops.ln_gemm(xf, w["ff1_ln_g"], w["ff1_ln_b"], eps, w["ff1_wi"], w["ff1_bi"], act=act)
    xf = ops.gemm(h, w["ff1_wo"], w["ff1_bo"], residual=xf, alpha=0.5)
    residual = xf

    # attention branch
    qkv, q_v = ops.ln_gemm(xf, w["attn_ln_g"], w["attn_ln_b"], eps, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])
    q_rot = ops.pos_query(q_v, w["wp"], tables["rot_cos"], tables["rot_sin"], T)
    heads = lambda i: qkv[:, i * H * hw:(i + 1) * H * hw].view(B, T, H, hw)
    attn = ops.rel_attention(heads(0), heads(1), heads(2), q_rot.view(B, T, H, d_rot),
                             tables["k_std"], lengths, profile)
    merged = torch.empty(M, 2 * D, dtype=BF16, device=x.device)
    ops.gemm(attn.view(M, H * hw), w["wo"], w["bo"], out=merged[:, :D])

    # cgMLP branch (channel_proj1 is always the profile's GELU)
    l = ops.ln_gemm(xf, w["cg_ln_g"], w["cg_ln_b"], eps, w["cg_w1"], w["cg_b1"], act=profile_act("gelu", profile))
    if "csgu_lin_w" in w:
        # the CSGU linear between the conv and the gate (pallas_layer.py:578-583)
        conv = ops.csgu_conv(l, w["csgu_ln_g"], w["csgu_ln_b"], w["csgu_dw"], w["csgu_dw_b"], B, T, t_valid, eps)
        gated = ops.gemm(conv, w["csgu_lin_w"], w["csgu_lin_b"], act=cfg.csgu_activation,
                         gate=l[:, : l.shape[1] // 2])
    else:
        gated = ops.csgu(l, w["csgu_ln_g"], w["csgu_ln_b"], w["csgu_dw"], w["csgu_dw_b"],
                         B, T, t_valid, cfg.csgu_activation, eps)
    ops.gemm(gated, w["cg_w2"], w["cg_b2"], out=merged[:, D:])

    # merge: concat + depthwise fusion + projection, residual
    merged = ops.merge_conv(merged, w["merge_dw"], w["merge_dw_b"], B, T, t_valid)
    xf = ops.gemm(merged, w["merge_w"], w["merge_b"], residual=residual, alpha=1.0)

    # macaron FF2, final LN
    h = ops.ln_gemm(xf, w["ff2_ln_g"], w["ff2_ln_b"], eps, w["ff2_wi"], w["ff2_bi"], act=act)
    xf = ops.gemm(h, w["ff2_wo"], w["ff2_bo"], residual=xf, alpha=0.5)
    return ops.layer_norm(xf, w["final_ln_g"], w["final_ln_b"], eps).view(B, T, D)


def _check_layer_args(x, w, cfg):
    if x.dtype != BF16 or x.ndim != 3:
        raise ValueError("x must be (B, T, D) bfloat16")
    if cfg.csgu_use_linear_after_conv != ("csgu_lin_w" in w):
        raise ValueError("the folded weights and the config disagree on csgu_use_linear_after_conv")


def ebranchformer_layer_plain(x, lengths, w, cfg, t_valid: int, tables, profile: str = "exact") -> torch.Tensor:
    """One inference layer in plain PyTorch on any device. x: (B, T, D) bf16,
    lengths: (B,) int32 key lengths; rows >= t_valid are masked out of both
    depthwise convs (padding rows below it are not re-zeroed). ``profile``:
    one of ``PROFILES`` (the module docstring)."""
    _check_layer_args(x, w, cfg)
    return _layer(x, lengths, w, cfg, t_valid, tables, PLAIN_OPS, check_profile(profile))


def ebranchformer_layer(x, lengths, w, cfg, t_valid: int, tables, profile: str = "exact") -> torch.Tensor:
    """``ebranchformer_layer_plain`` on CPU tensors; on CUDA tensors every
    piece runs its kernel."""
    _check_layer_args(x, w, cfg)
    return _layer(x, lengths, w, cfg, t_valid, tables, KERNEL_OPS, check_profile(profile))
