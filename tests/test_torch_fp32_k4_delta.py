"""PyTorch port, the fp32 training attention's backward delta vs the JAX
kernel's, on the CPU.

The fp32 backward kernels of ``csrc/rel_attention_train.cu`` take delta as
rowsum(dO * out) from the forward's output (``delta_plain`` is the plain
version of their delta kernel). The JAX kernel
(``ops/pallas_train_attention.py::_bwd_kernel``) takes rowsum(dP * P32) over
the fp32 probabilities and the dropped, scaled dP. With Pd = keep P inv_keep
and dP = keep (dO v^T) inv_keep, rowsum(dP P) = dO . sum_s Pd_s v_s =
dO . out: the same value up to fp32 rounding (in bf16, where out is built
from the rounded P, they differ: ``test_torch_train_attention.py``'s
``test_delta_is_the_row_sum_over_the_unrounded_probabilities``).

Here, in fp32: the JAX kernel's forward in interpret mode gives out, and
rowsum(dP * P32) is formed per head from the JAX module's own score,
softmax and keep-mask functions, as its backward kernel forms it; the
port's plain forward gives its own out. Both rowsum(dO * out) agree with it
within 1e-5 of its scale (its largest magnitude), at rates 0 and 0.1, with
rows of length T, 1 and 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.ops.pallas_train_attention import _head_scores, _keep_mask, _softmax
from huggingface_asr_tpu.ops.pallas_train_attention import rel_attention_train as j_rel_attention_train

from huggingface_asr_tpu_torch.kernels.train_attention import delta_plain, rel_attention_train

B, T, H, DH, D = 3, 45, 2, 8, 16
LENGTHS = [45, 1, 0]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q_u=mk(B, T, H, DH), q_rot=0.25 * mk(B, T, H, D), k=mk(B, T, H, DH), v=mk(B, T, H, DH),
                k_std=mk(T, D), cot=mk(B, T, H, DH), lengths=np.asarray(LENGTHS, np.int32))


def _jax_delta(x, seed, rate):
    """(B, H, T) rowsum(dP * P32), as ``_bwd_kernel`` takes it."""
    inv_keep = np.float32(1.0 / (1.0 - rate)) if rate > 0.0 else np.float32(1.0)
    k_std = jnp.asarray(x["k_std"])
    rows = []
    for b in range(B):
        heads = []
        for h in range(H):
            scores = _head_scores(jnp.asarray(x["q_u"][b, :, h]), jnp.asarray(x["q_rot"][b, :, h]),
                                  jnp.asarray(x["k"][b, :, h]), k_std, int(x["lengths"][b]), T, DH)
            p32 = _softmax(scores)
            dp = jnp.asarray(x["cot"][b, :, h]) @ jnp.asarray(x["v"][b, :, h]).T
            if rate > 0.0:
                dp = jnp.where(_keep_mask(jnp.int32(seed), h, b, H, T, rate, True), dp * inv_keep, 0.0)
            heads.append(np.asarray(jnp.sum(dp * p32, axis=-1)))
        rows.append(heads)
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("rate,seed", [(0.0, 5), (0.1, 77)])
def test_fp32_delta_from_the_output_matches_the_jax_kernels_row_sum(rate, seed):
    x = _inputs(seed)
    ref = _jax_delta(x, seed, rate)
    scale = float(np.abs(ref).max())
    assert scale > 1.0
    cot = torch.from_numpy(x["cot"])

    j_out = j_rel_attention_train(*(jnp.asarray(x[n]) for n in ("q_u", "q_rot", "k", "v", "k_std")),
                                  jnp.asarray(x["lengths"]), jnp.int32(seed), rate, True)
    got_jax = delta_plain(torch.from_numpy(np.array(j_out)), cot).numpy()
    out = rel_attention_train(*(torch.from_numpy(x[n]) for n in ("q_u", "q_rot", "k", "v", "k_std")),
                              torch.from_numpy(x["lengths"]), seed, rate)
    got = delta_plain(out, cot).numpy()
    for name, g in (("JAX out", got_jax), ("port out", got)):
        assert g.shape == (B, H, T) and g.dtype == np.float32, name
        assert np.abs(g - ref).max() <= 1e-5 * scale, (name, np.abs(g - ref).max(), scale)
    if rate == 0.0:  # a row of length 1 attends to its first key only: out = v of that key
        np.testing.assert_allclose(got[1], (x["cot"][1] * x["v"][1, 0]).sum(-1).T, rtol=1e-5, atol=1e-5)
