"""PyTorch port, shift-form inference attention (K5) vs the JAX package on the CPU.

The same numpy inputs go through ``rel_attention(..., interpret=True)`` (the
Pallas kernel in interpret mode) and ``rel_attention_reference`` of the JAX
package, and through the port's ``rel_attention``, which on CPU tensors runs
its plain version. fp32: rtol/atol 2e-5 (summation order). bf16: 2^-6 of the
scale (isolated bf16 ulp flips).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.ops.pallas_attention import rel_attention as j_rel_attention
from huggingface_asr_tpu.ops.pallas_attention import rel_attention_reference

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels.attention import rel_attention, rel_attention_plain_shift

H, DH = 2, 8
SHAPES = {"ragged": (2, 32, [32, 21]), "odd_T": (2, 19, [19, 5]), "zero_len": (3, 16, [16, 0, 9])}


def _inputs(shape, seed=0):
    B, T, lens = SHAPES[shape]
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [mk(B, T, H, DH), mk(B, T, H, DH), mk(B, T, H, DH), mk(B, T, H, DH),
            mk(2 * T - 1, H, DH), np.asarray(lens, np.int32)]


def _port(x, dtype=torch.float32, fn=rel_attention):
    args = [torch.from_numpy(a).to(dtype) for a in x[:5]] + [torch.from_numpy(x[5])]
    return fn(*args).float().numpy()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fp32_matches_jax_reference(shape):
    x = _inputs(shape)
    _build.reset_launch_counts()
    got = _port(x)
    assert sum(_build.LAUNCHES.values()) == 0
    ref = np.asarray(rel_attention_reference(*[jnp.asarray(a) for a in x]))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", ["ragged", "zero_len"])
def test_fp32_matches_jax_kernel_interpret(shape):
    # the Pallas kernel's roll needs T a multiple of 8 in interpret mode too
    x = _inputs(shape, seed=1)
    ref = np.asarray(j_rel_attention(*[jnp.asarray(a) for a in x], interpret=True))
    np.testing.assert_allclose(_port(x), ref, rtol=2e-5, atol=2e-5)


def test_bf16_matches_jax_reference():
    x = _inputs("ragged", seed=2)
    got = _port(x, torch.bfloat16)
    ref = np.asarray(rel_attention_reference(*[jnp.asarray(a, jnp.bfloat16) for a in x[:5]],
                                             jnp.asarray(x[5])), np.float32)
    assert np.abs(got - ref).max() <= 2 ** -6 * max(1.0, np.abs(ref).max())


def test_wrapper_on_cpu_is_the_plain_version():
    x = _inputs("odd_T", seed=3)
    np.testing.assert_array_equal(_port(x), _port(x, fn=rel_attention_plain_shift))
