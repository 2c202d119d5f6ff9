"""BEST-RQ self-supervised pretraining (counterpart of
``huggingface_asr_tpu/models/bestrq.py``; reference src/models/bestrq.py).

A frozen random projection P and a frozen L2-normalised codebook CB quantize
stacked raw mel frames into targets; the encoder sees the mel features with
the masked frames replaced by N(0, 0.1^2) noise after the feature
projection; one linear classifier a book predicts the targets from the
encoder output, trained with the cross entropy summed over the masked valid
frames and divided by the number of books (the trainer then divides by the
masked-frame count).

P and CB are registered buffers, never parameters: the optimizer does not
see them and the checkpoint carries them. ``make_bestrq_buffers`` builds them
as the JAX package does, from ``jax.random.key(0)`` and ``key(1)`` (the
default threefry2x32 generator, partitionable bits), without JAX: a numpy
threefry2x32 and jax.random's uniform and normal transforms. P is XLA's to
the bit (its ``x * (max - min) + min`` is one fused multiply-add there, and
here). CB goes through XLA's float32 ``erf_inv``, whose ``log1p`` is XLA's own
approximation: this copy evaluates the same polynomial over a correctly
rounded ``log1p``, and its CB differs from XLA's by a few ulp on some
entries (``tests/test_torch_bestrq.py`` states how many); the targets, an
argmax over the codebook, are held equal instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng, EBranchformerModel, _lin
from huggingface_asr_tpu_torch.parallel.mesh import row_draw

_F32 = np.float32


# ---------------------------------------------------------------------------
# jax.random's threefry2x32 bits and its uniform / normal transforms, in numpy


def _threefry2x32(k1: int, k2: int, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 block cipher (20 rounds) on counter pairs (x0, x1)."""
    u = np.uint32
    x = [np.asarray(x0, np.uint32).copy(), np.asarray(x1, np.uint32).copy()]
    ks = [u(k1), u(k2), u(k1) ^ u(k2) ^ u(0x1BD11BDA)]
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x[0] = x[0] + ks[0]
    x[1] = x[1] + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << u(r)) | (x[1] >> u(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + u(i + 1)
    return x


def random_bits(seed: int, shape) -> np.ndarray:
    """``jax.random.bits(jax.random.key(seed), shape)`` (uint32), seed in
    [0, 2^32): element i is the xor of the cipher's two words on the counter
    pair (i >> 32, i & 0xFFFFFFFF) under the key (0, seed)."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64)
    a, b = _threefry2x32(0, seed, (i >> 32).astype(np.uint32), (i & 0xFFFFFFFF).astype(np.uint32))
    return (a ^ b).reshape(shape)


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as a fused multiply-add (the product of
    two float32 values is exact in float64)."""
    return (a.astype(np.float64) * np.float64(b) + np.asarray(c, np.float64)).astype(_F32)


def random_uniform(seed: int, shape, minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform(jax.random.key(seed), shape, float32, minval, maxval)``:
    23 random mantissa bits under the exponent of 1.0, minus 1, scaled."""
    bits = random_bits(seed, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(_F32) - _F32(1.0)
    lo, hi = _F32(minval), _F32(maxval)
    return np.maximum(lo, _fma32(floats, hi - lo, lo))


# XLA's float32 erf_inv (Giles' polynomials in w = -log(1 - x^2), split at w = 5)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                  -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                  -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erf_inv32(x: np.ndarray) -> np.ndarray:
    x = x.astype(_F32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(_F32)
    small = w < _F32(5.0)
    w = np.where(small, w - _F32(2.5), np.sqrt(w) - _F32(3.0)).astype(_F32)
    p = np.where(small, _F32(_ERFINV_W_LT_5[0]), _F32(_ERFINV_W_GE_5[0])).astype(_F32)
    for c_small, c_large in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = _fma32(p, w, np.where(small, _F32(c_small), _F32(c_large)))
    return np.where(np.abs(x) == 1.0, x * np.finfo(_F32).max, p * x).astype(_F32)


def random_normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(jax.random.key(seed), shape)`` in float32:
    sqrt(2) erf_inv(u), u uniform in (-1, 1)."""
    u = random_uniform(seed, shape, np.nextafter(_F32(-1.0), _F32(0.0)), 1.0)
    return (_F32(np.sqrt(2.0)) * _erf_inv32(u)).astype(_F32)


def _l2_normalize(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    norm = np.sqrt(np.sum(x * x, axis=-1, keepdims=True, dtype=_F32))
    return (x / np.maximum(norm, _F32(eps))).astype(_F32)


def make_bestrq_buffers(cfg: EBranchformerConfig) -> Dict[str, torch.Tensor]:
    """The frozen quantizer's buffers, deterministic from the config as the
    JAX package's ``make_bestrq_buffers``: P (books, in_dim, codebook_dim),
    xavier-uniform over its last two dims from key 0, and CB (books,
    codebook_size, codebook_dim), L2-normalised standard normals from key 1;
    float32 tensors on the CPU."""
    k, f, d = cfg.best_rq_num_books, cfg.best_rq_in_dim, cfg.best_rq_codebook_dim
    a = np.sqrt(6.0 / (f + d))
    P = random_uniform(0, (k, f, d), -a, a)
    CB = _l2_normalize(random_normal(1, (k, cfg.best_rq_codebook_size, d)))
    return {"P": torch.from_numpy(P), "CB": torch.from_numpy(CB)}


# ---------------------------------------------------------------------------
# The model


class RandomProjectionQuantizer(nn.Module):
    """Frozen projection P and codebook CB (reference bestrq.py:66-80):
    targets = argmax over the codebook of <CB, normalise(stacked @ P)>, which
    is the nearest code, both sides being L2-normalised."""

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        buffers = make_bestrq_buffers(cfg)
        self.register_buffer("P", buffers["P"])
        self.register_buffer("CB", buffers["CB"])

    @torch.no_grad()
    def forward(self, stacked: torch.Tensor) -> torch.Tensor:
        """(B, T, in_dim) -> (B, books, T) int64 targets, in float32."""
        proj = torch.einsum("btf,kfd->bktd", stacked.float(), self.P)
        proj = proj / torch.clamp(torch.linalg.vector_norm(proj, dim=-1, keepdim=True), min=1e-12)
        sims = torch.einsum("bktd,kvd->bktv", proj, self.CB)
        return sims.argmax(dim=-1)


@dataclasses.dataclass
class BestRQOutput:
    loss: torch.Tensor  # summed CE over masked valid frames / num_books
    num_masked: torch.Tensor
    logits: torch.Tensor  # (books, B, T, codebook_size)
    targets: torch.Tensor  # (B, books, T)
    last_hidden_state: torch.Tensor


class BestRQForPreTraining(nn.Module):
    """E-Branchformer encoder (``wav2vec2``) + the BEST-RQ objective: the
    quantizer ``rpq`` and one classifier a book (``classifiers``)."""

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.config = cfg
        self.wav2vec2 = EBranchformerModel(cfg)
        self.classifiers = nn.ModuleList(
            [nn.Linear(cfg.hidden_size, cfg.best_rq_codebook_size) for _ in range(cfg.best_rq_num_books)])
        self.rpq = RandomProjectionQuantizer(cfg)

    def forward(
        self,
        input_features: torch.Tensor,
        input_lengths: torch.Tensor,
        mask_time_indices: torch.Tensor,
        mask_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        rng: Optional[DropoutRng] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> BestRQOutput:
        """input_features (B, T_mel, F): the targets come from them in float32,
        the encoder runs in ``dtype`` (default: theirs). mask_time_indices
        (B, T_enc) bool over encoder frames. The masked frames' noise is
        ``mask_noise`` (B, T_enc, hidden), or 0.1 N(0, 1) drawn from
        ``generator``. ``rng`` given: the training forward (dropout on)."""
        cfg = self.config
        B, _, n_mel = input_features.shape
        T_enc = mask_time_indices.shape[1]
        stack = cfg.best_rq_in_dim // cfg.num_fbanks
        dtype = dtype or input_features.dtype

        # (JAX's reshape raises where 4 T_enc passes T_mel, as at 998 frames of 10 s: here the
        # missing frames are zeros; they belong to frames past the returned lengths)
        usable = T_enc * stack
        stacked = F.pad(input_features[:, :usable], (0, 0, 0, max(0, usable - input_features.shape[1])))
        targets = self.rpq(stacked.reshape(B, T_enc, stack * n_mel))  # (B, K, T)

        if mask_noise is None:
            mask_noise = 0.1 * row_draw(torch.randn, (B, T_enc, cfg.hidden_size), generator=generator,
                                           device=input_features.device, dtype=torch.float32)
        mask = mask_time_indices.to(torch.bool)
        hidden, lengths, _, _ = self.wav2vec2(input_features.to(dtype), input_lengths, rng,
                                              mask_time_indices=mask, mask_noise=mask_noise.to(dtype))
        logits = torch.stack([_lin(c, hidden) for c in self.classifiers])  # (K, B, T, V)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets.transpose(0, 1)[..., None])[..., 0]  # (K, B, T)
        valid = mask & (torch.arange(T_enc, device=mask.device)[None, :] < lengths[:, None])
        loss = torch.sum(nll * valid[None].float()) / cfg.best_rq_num_books
        return BestRQOutput(loss=loss, num_masked=valid.sum(), logits=logits, targets=targets,
                            last_hidden_state=hidden)
