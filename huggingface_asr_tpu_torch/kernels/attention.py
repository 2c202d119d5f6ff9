"""Relative-position self-attention for inference, shift form
(counterpart of ``huggingface_asr_tpu/ops/pallas_attention.py``).

    scores[t, s] = (q_u[t] . k[s] + q_v[t] . pos[t - s + T - 1, h]) / sqrt(dh)
    columns >= length := -1e9;  P = softmax in fp32, cast;  out = P v

``rel_attention`` has the JAX function's signature. On CUDA tensors it
launches ``asr_rel_attention_shift`` (bf16 runs the wgmma + TMA kernel of
``csrc/rel_attention_shift_bf16.cu``, fp32 the register-tiled FFMA kernel
of ``csrc/rel_attention_shift.cu``, one walk of the keys) or raises; on CPU
tensors it runs
``rel_attention_plain_shift``. The kernels are compiled for heads of 32 and
64 columns: a head size of at most 64 is padded with zero columns to the
next of the two, in copies of the five operands (a zero column adds an exact
zero to every sum), the scale staying 1/sqrt(dh) of the true head size, and
the output's true columns are returned. Inference only: no gradient is
defined.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from huggingface_asr_tpu_torch.kernels import _build

HEAD_WIDTHS = (32, 64)  # the head widths every attention kernel is compiled for
ROT_MAX = 512  # the widest q_rot the inference and training attention kernels take


def head_width(dh: int):
    """The attention kernels' head width for head size ``dh``: the smallest of
    ``HEAD_WIDTHS`` that holds it (zero columns pad the rest), None past 64."""
    return next((w for w in HEAD_WIDTHS if dh <= w), None)

NEG_INF = -1.0e9


def rel_attention_plain_shift(q_u, q_v, k, v, pos, lengths):
    """Plain PyTorch version (``rel_attention_reference`` of the JAX module):
    the positional table is gathered to (T, T, H, dh), products accumulate in fp32."""
    B, T, H, dh = q_u.shape
    t = torch.arange(T, device=q_u.device)
    ac = torch.einsum("bthd,bshd->bhts", q_u.float(), k.float())
    pos_g = pos[t[:, None] - t[None, :] + (T - 1)]  # (T, T, H, dh)
    bd = torch.einsum("bthd,tshd->bhts", q_v.float(), pos_g.float())
    scores = (ac + bd) * float(np.float32(1.0 / np.sqrt(dh)))
    scores = torch.where(t[None, None, None, :] < lengths[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(q_u.dtype)


def rel_attention(q_u, q_v, k, v, pos, lengths):
    """q_u, q_v, k, v: (B, T, H, dh); pos: (2T-1, H, dh) projected positional
    table; lengths: (B,) int32 valid key counts. Returns (B, T, H, dh)."""
    if not _build.on_cuda(q_u, q_v, k, v, pos, lengths):
        return rel_attention_plain_shift(q_u, q_v, k, v, pos, lengths)
    B, T, H, dh = q_u.shape
    dtype = q_u.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rel_attention: bf16 or fp32 inputs, got {dtype}")
    hw = head_width(dh)
    if hw is None:
        raise ValueError(f"rel_attention kernel takes head sizes of at most {HEAD_WIDTHS[-1]}, got {dh}")
    q_u, q_v, k, v, pos = (t.contiguous() for t in (q_u, q_v, k, v, pos))
    for name, t in (("q_u", q_u), ("q_v", q_v), ("k", k), ("v", v)):
        _build.check(t, name, dtype, (B, T, H, dh))
    _build.check(pos, "pos", dtype, (2 * T - 1, H, dh))
    _build.check(lengths, "lengths", torch.int32, (B,))
    if hw != dh:
        q_u, q_v, k, v, pos = (F.pad(t, (0, hw - dh)) for t in (q_u, q_v, k, v, pos))
    out = torch.empty_like(q_u)
    _build.launch("asr_rel_attention_shift", "pppppppiiiiif", q_u.data_ptr(), q_v.data_ptr(),
                  k.data_ptr(), v.data_ptr(), pos.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  B, T, H, hw, int(dtype == torch.bfloat16), float(np.float32(1.0 / np.sqrt(dh))))
    return out[..., :dh]
