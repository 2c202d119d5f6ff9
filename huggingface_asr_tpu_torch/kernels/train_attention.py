"""Relative-position attention core for training: forward and backward
(counterpart of ``huggingface_asr_tpu/ops/pallas_train_attention.py``).

    S = (q_u k^T + q_rot k_std^T) / sqrt(dh);  columns >= length := -1e9
    P = softmax(S) in fp32, cast to the input dtype
    Pd = keep ? P * dtype(1 / (1 - rate)) : 0;  out = Pd v

``rel_attention_train`` is a ``torch.autograd.Function``: on CUDA tensors its
forward launches the forward kernel (bf16: ``csrc/rel_attention_train_fwd.cu``,
fp32: ``csrc/rel_attention_train.cu``) and its backward the backward kernels
(bf16: ``csrc/rel_attention_train_bwd.cu``, dq then dk/dv; fp32:
``csrc/rel_attention_train.cu``, delta, dk/dv, then dq); on CPU tensors it runs
``rel_attention_train_plain``. Nothing falls back: a CUDA tensor the kernels
do not take raises. Gradients exist for q_u, q_rot, k and v only.

The kernels are compiled for heads of 32 and 64 columns and read q_rot and
k_std in whole 64-column (bf16) or 16-column (fp32) tiles, up to 512 columns
in both. The fp32 kernels are register-tiled FFMA products that stream
``[q_u | q_rot]`` and ``[k | k_std]`` through rings of column chunks in
shared memory: the forward walks the keys once (online softmax), and the
backward forms S
once, in its dk/dv kernel, which writes dS (fp32) to a (B, H, T, ld)
scratch that the dq kernel multiplies by ``[k | k_std]``; its delta is
``rowsum(dO * out)`` (``delta_plain``), so the Function keeps the forward's
output for fp32. Where the
bf16 dq kernel's ``[dq_u | dq_rot]`` accumulator passes its registers (head
width + q_rot width > ``ACC_COLUMNS``), the backward is
``asr_rel_attention_train_bwd_wide``: it writes dS (bf16, the rounding the
products read) beside dq_u, dk and dv, and ``dq_rot = dS k_std`` is one call
of the GEMM kernel (``kernels/layer.py::gemm``). The Function pads
other sizes with zero columns, in copies (q_u, k, v to the head width,
q_rot and k_std to the tile width), launches the kernels on the copies and
returns the gradients' true columns; the scale stays 1/sqrt(dh) of the true
head size. A zero column adds an exact zero to every fp32 sum, and the keep
mask is a function of (b, h, t, s) alone, so the padding changes no value.

The dropout keep-mask is the counter hash of the JAX kernel's interpret
branch (``_keep_mask``), a pure function of (seed, batch row, head, t, s, T),
so the plain version, the kernels and ``rel_attention_train(...,
interpret=True)`` of the JAX package drop the same elements.

The plain version is itself an explicit forward/backward pair with the TPU
kernel's rounding points (P rounded before the dropout scale, dv from the
dropped P, ``rowsum(dP * P)`` over the fp32 P, dS rounded before its three
products), so that it says what the kernels compute in bf16 too; in fp32 it
equals autograd of the naive formula. The fp32 kernels take delta as
``rowsum(dO * out)``: with ``Pd = keep * P * inv_keep`` and ``dP = keep *
(dO v^T) * inv_keep``, ``rowsum(dP * P) = dO . sum_s Pd_s v_s = dO . out``,
the same value up to fp32 rounding (in bf16 out is built from the rounded P,
and the two differ).
"""

from __future__ import annotations

import numpy as np
import torch

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels.attention import ROT_MAX, head_width

NEG_INF = -1.0e9
_M32 = 0xFFFFFFFF
_GOLDEN, _C1, _C2 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for an int64 tensor of 32-bit values, without
    overflowing int64: two 48-bit partial products."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash_round(x: torch.Tensor) -> torch.Tensor:
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    return int(rate * float(2 ** 32))


def keep_mask(seed: int, B: int, H: int, T: int, rate: float, device=None, row0: int = 0) -> torch.Tensor:
    """(B, H, T, T) bool keep-mask: wrapping-uint32 arithmetic on int64
    tensors. The hash numbers the batch rows from ``row0``: a data-parallel
    rank's rows get their rows' masks of the global batch."""
    bh = torch.arange(row0 * H, (row0 + B) * H, dtype=torch.int64, device=device)
    mixed = (int(seed) & _M32) ^ _mul32(bh, _GOLDEN)
    mixed = _hash_round(_hash_round(mixed))
    key = _mul32(mixed, _GOLDEN)
    t = torch.arange(T, dtype=torch.int64, device=device)
    ctr = (t[:, None] * T + t[None, :]) & _M32
    x = ctr[None] ^ key[:, None, None]
    x = _hash_round(_hash_round(_hash_round(x)))
    return (x >= dropout_threshold(rate)).view(B, H, T, T)


def _probs(q_u, q_rot, k, k_std, lengths):
    """fp32 softmax of the scaled, masked scores: (B, H, T, T)."""
    T, dh = q_u.shape[1], q_u.shape[-1]
    ac = torch.einsum("bthd,bshd->bhts", q_u.float(), k.float())
    bd = torch.einsum("bthD,sD->bhts", q_rot.float(), k_std.float())
    scores = (ac + bd) * float(np.float32(1.0 / np.sqrt(dh)))
    col = torch.arange(T, device=q_u.device)
    scores = torch.where(col[None, None, None, :] < lengths[:, None, None, None], scores, NEG_INF)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _dropped(p32, dtype, keep, rate):
    p = p32.to(dtype)
    if keep is None:
        return p
    inv_keep = torch.tensor(np.float32(1.0 / (1.0 - rate)), dtype=torch.float32).to(dtype)
    return torch.where(keep, p * inv_keep.to(p.device), torch.zeros((), dtype=dtype, device=p.device))


class _PlainFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_u, q_rot, k, v, k_std, lengths, seed, rate, row0):
        B, T, H, _ = q_u.shape
        keep = keep_mask(seed, B, H, T, rate, q_u.device, row0) if rate > 0.0 else None
        pd = _dropped(_probs(q_u, q_rot, k, k_std, lengths), q_u.dtype, keep, rate)
        ctx.save_for_backward(q_u, q_rot, k, v, k_std, lengths)
        ctx.seed, ctx.rate, ctx.row0 = seed, rate, row0
        return torch.einsum("bhts,bshd->bthd", pd.float(), v.float()).to(q_u.dtype)

    @staticmethod
    def backward(ctx, d_out):
        q_u, q_rot, k, v, k_std, lengths = ctx.saved_tensors
        rate, dtype = ctx.rate, q_u.dtype
        B, T, H, dh = q_u.shape
        keep = keep_mask(ctx.seed, B, H, T, rate, q_u.device, ctx.row0) if rate > 0.0 else None
        p32 = _probs(q_u, q_rot, k, k_std, lengths)
        pd = _dropped(p32, dtype, keep, rate)
        do = d_out.float()
        dv = torch.einsum("bhts,bthd->bshd", pd.float(), do)
        dp = torch.einsum("bthd,bshd->bhts", do, v.float())
        if keep is not None:
            dp = torch.where(keep, dp * float(np.float32(1.0 / (1.0 - rate))), 0.0)
        ds = p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))
        ds = (ds * float(np.float32(1.0 / np.sqrt(dh)))).to(dtype).float()
        dq_u = torch.einsum("bhts,bshd->bthd", ds, k.float())
        dk = torch.einsum("bhts,bthd->bshd", ds, q_u.float())
        dq_rot = torch.einsum("bhts,sD->bthD", ds, k_std.float())
        return (dq_u.to(dtype), dq_rot.to(q_rot.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def delta_plain(out: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """Plain version of the fp32 backward's delta kernel: ``rowsum(dO * out)``
    over the head's columns, (B, T, H, dh) -> (B, H, T) fp32."""
    return (d_out.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def rel_attention_train_plain(q_u, q_rot, k, v, k_std, lengths, seed, dropout_rate=0.0, row0=0):
    """Plain PyTorch version of ``rel_attention_train``, on any device,
    differentiable in q_u, q_rot, k and v."""
    return _PlainFunction.apply(q_u, q_rot, k, v, k_std, lengths, int(seed), float(dropout_rate), int(row0))


ACC_COLUMNS = 288  # the bf16 dq kernel's [dq_u | dq_rot] accumulator, in registers
ROT_STEP = {torch.bfloat16: 64, torch.float32: 16}  # the kernels' q_rot tile width, by dtype


def padded_widths(dh: int, D: int, dtype: torch.dtype):
    """(head width, q_rot width) the kernels run ``(dh, D)`` at in ``dtype``,
    or None where they do not take it: a head of at most 64 columns, q_rot in
    whole tiles of 64 (bf16) or 16 (fp32) columns, at most ``ROT_MAX`` (512)
    of them."""
    hw = head_width(dh)
    if dtype not in ROT_STEP or hw is None:
        return None
    step = ROT_STEP[dtype]
    d_rot = -(-D // step) * step
    return (hw, d_rot) if d_rot <= ROT_MAX else None


def wide_backward(hw: int, d_rot: int, dtype: torch.dtype) -> bool:
    """Whether the backward at these padded widths writes dS and forms dq_rot
    in a GEMM (``asr_rel_attention_train_bwd_wide``): bf16 past the dq
    kernel's register accumulator."""
    return dtype == torch.bfloat16 and hw + d_rot > ACC_COLUMNS


def _check_inputs(q_u, q_rot, k, v, k_std, lengths):
    """Raise unless the kernels take these operands; return (B, T, H, dh, D,
    head width, q_rot width)."""
    B, T, H, dh = q_u.shape
    D = q_rot.shape[-1]
    dtype = q_u.dtype
    widths = padded_widths(dh, D, dtype)
    if widths is None:
        raise ValueError(f"rel_attention_train kernels need bf16 or fp32 inputs, dh <= 64 and D <= {ROT_MAX}, "
                         f"got dh={dh}, D={D}, {dtype}; attention_impl='xla' selects the plain attention")
    _build.check(q_u, "q_u", dtype, (B, T, H, dh))
    _build.check(q_rot, "q_rot", dtype, (B, T, H, D))
    _build.check(k, "k", dtype, (B, T, H, dh))
    _build.check(v, "v", dtype, (B, T, H, dh))
    _build.check(k_std, "k_std", dtype, (T, D))
    _build.check(lengths, "lengths", torch.int32, (B,))
    return (B, T, H, dh, D) + widths


def _pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (contiguous) with its last dimension padded with zeros to
    ``width``: a copy, or ``t`` itself where it has that width."""
    n = t.shape[-1]
    return t if n == width else torch.nn.functional.pad(t, (0, width - n))


class _KernelFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_u, q_rot, k, v, k_std, lengths, seed, rate, row0):
        q_u, q_rot, k, v, k_std = (t.contiguous() for t in (q_u, q_rot, k, v, k_std))
        B, T, H, dh, D, hw, d_rot = _check_inputs(q_u, q_rot, k, v, k_std, lengths)
        q_u, k, v = (_pad_last(t, hw) for t in (q_u, k, v))
        q_rot, k_std = _pad_last(q_rot, d_rot), _pad_last(k_std, d_rot)
        out = torch.empty_like(q_u)
        stats = torch.empty(2, B, H, T, dtype=torch.float32, device=q_u.device)
        ctx.widths = (dh, D)
        ctx.tail = (B, T, H, hw, d_rot, int(q_u.dtype == torch.bfloat16),
                    float(np.float32(1.0 / np.sqrt(dh))), seed & _M32, dropout_threshold(rate),
                    float(np.float32(1.0 / (1.0 - rate))) if rate > 0.0 else 1.0, int(rate > 0.0), row0)
        _build.launch("asr_rel_attention_train_fwd", "ppppppppiiiiiifuufii",
                      q_u.data_ptr(), q_rot.data_ptr(), k.data_ptr(), v.data_ptr(),
                      k_std.data_ptr(), lengths.data_ptr(), out.data_ptr(), stats.data_ptr(),
                      *ctx.tail)
        # the fp32 backward's delta reads the forward's output
        ctx.save_for_backward(q_u, q_rot, k, v, k_std, lengths, stats, *([out] if q_u.dtype == torch.float32 else []))
        return out[..., :dh]

    @staticmethod
    def backward(ctx, d_out):
        q_u, q_rot, k, v, k_std, lengths, stats = ctx.saved_tensors[:7]
        B, T, H = ctx.tail[:3]
        dh, D = ctx.widths
        d_out = d_out.contiguous()
        _build.check(d_out, "d_out", q_u.dtype, (B, T, H, dh))
        d_out = _pad_last(d_out, q_u.shape[-1])
        dq_u, dq_rot = torch.empty_like(q_u), torch.empty_like(q_rot)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty(B, H, T, dtype=torch.float32, device=q_u.device)
        hw, d_rot = ctx.tail[3:5]
        if q_u.dtype == torch.float32:
            # dS (B, H, T, ld): the dk/dv kernel writes every visited key tile whole (zeros past the
            # visited keys), the dq kernel reads no further, so the scratch needs no zeroing
            ld = -(-T // 64) * 64
            ds = torch.empty(B, H, T, ld, dtype=torch.float32, device=q_u.device)
            out = ctx.saved_tensors[7]
            _build.launch("asr_rel_attention_train_bwd_fp32", "pppppppppppppppiiiiiifuufii",
                          q_u.data_ptr(), q_rot.data_ptr(), k.data_ptr(), v.data_ptr(), k_std.data_ptr(),
                          lengths.data_ptr(), out.data_ptr(), d_out.data_ptr(), stats.data_ptr(),
                          delta.data_ptr(), ds.data_ptr(), dq_u.data_ptr(), dq_rot.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), B, T, H, hw, d_rot, ld, *ctx.tail[6:], label="asr_rel_attention_train_bwd")
        elif wide_backward(hw, d_rot, q_u.dtype):
            from huggingface_asr_tpu_torch.kernels.layer import gemm  # (layer.py imports the model, which imports this)

            # dS (B, T, H, ld) with zeros past the visited keys, then
            # dq_rot (B*T*H, D) = dS (B*T*H, ld) @ k_std (ld, D), k_std's rows past T zero
            ld = -(-T // 8) * 8
            ds = torch.zeros(B, T, H, ld, dtype=q_u.dtype, device=q_u.device)
            _build.launch("asr_rel_attention_train_bwd_wide", "pppppppppppppiiiiiifuufii",
                          q_u.data_ptr(), q_rot.data_ptr(), k.data_ptr(), v.data_ptr(),
                          k_std.data_ptr(), lengths.data_ptr(), d_out.data_ptr(), stats.data_ptr(),
                          delta.data_ptr(), dq_u.data_ptr(), ds.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          B, T, H, hw, d_rot, ld, *ctx.tail[6:], label="asr_rel_attention_train_bwd")
            gemm(ds.view(B * T * H, ld), torch.nn.functional.pad(k_std, (0, 0, 0, ld - T)),
                 out=dq_rot.view(B * T * H, d_rot))
        else:
            _build.launch("asr_rel_attention_train_bwd", "pppppppppppppiiiiiifuufii",
                          q_u.data_ptr(), q_rot.data_ptr(), k.data_ptr(), v.data_ptr(),
                          k_std.data_ptr(), lengths.data_ptr(), d_out.data_ptr(), stats.data_ptr(),
                          delta.data_ptr(), dq_u.data_ptr(), dq_rot.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), *ctx.tail)
        return (dq_u[..., :dh], dq_rot[..., :D], dk[..., :dh], dv[..., :dh],
                None, None, None, None, None)


def rel_attention_train(q_u, q_rot, k, v, k_std, lengths, seed, dropout_rate=0.0, row0=0):
    """Attention core with in-kernel dropout.

    q_u, k, v: (B, T, H, dh); q_rot: (B, T, H, D) rotary-transformed
    positional query; k_std: (T, D) ascending sinusoid table (no gradient);
    lengths: (B,) int32 valid key counts; seed: int (int32 range); row0: the
    number the dropout hash gives batch row 0 (a data-parallel rank's first
    row of the global batch, so its masks are that batch's); returns
    (B, T, H, dh) in q_u's dtype. CUDA tensors run the kernels (dh <= 64,
    D <= 512, each padded with zeros to what the kernels are compiled for:
    ``padded_widths``), CPU tensors the plain version."""
    seed, rate, row0 = int(seed), float(dropout_rate), int(row0)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if not _build.on_cuda(q_u, q_rot, k, v, k_std, lengths):
        return _PlainFunction.apply(q_u, q_rot, k, v, k_std, lengths, seed, rate, row0)
    return _KernelFunction.apply(q_u, q_rot, k, v, k_std, lengths, seed, rate, row0)
