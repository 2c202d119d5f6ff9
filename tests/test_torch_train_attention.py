"""PyTorch port, training attention (K4) vs the JAX package on the CPU.

The same numpy inputs go through ``rel_attention_train(..., interpret=True)``
of the JAX package (its Pallas kernel in interpret mode) and through the
port's ``rel_attention_train``, which on CPU tensors runs its plain version.
The dropout keep-mask is a counter hash of (seed, b, h, t, s, T) on both
sides, so with dropout on the two agree at the tolerances of rate 0:
fp32 forward rtol/atol 2e-5, gradients 2e-4 (fp32 products sum in another
order). bf16: 2^-6 of each tensor's scale, i.e. isolated 1-2 bf16 ulp flips
where an fp32 value sits on a rounding boundary.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.ops.pallas_train_attention import _keep_mask
from huggingface_asr_tpu.ops.pallas_train_attention import rel_attention_train as j_rel_attention_train

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels.train_attention import (
    keep_mask,
    _check_inputs,
    rel_attention_train,
    rel_attention_train_plain,
)

H, DH, D = 2, 8, 16
# (B, T, lengths): ragged; T not a multiple of 8; a zero-length row
SHAPES = {
    "ragged": (2, 32, [32, 22]),
    "odd_T": (2, 27, [27, 13]),
    "zero_len": (3, 20, [20, 0, 7]),
}


def _inputs(shape, seed=0):
    B, T, lens = SHAPES[shape]
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q_u=mk(B, T, H, DH), q_rot=mk(B, T, H, D), k=mk(B, T, H, DH), v=mk(B, T, H, DH),
                k_std=mk(T, D), lengths=np.asarray(lens, np.int32), cot=mk(B, T, H, DH))


def _jax_run(x, seed, rate, dtype=jnp.float32):
    args = [jnp.asarray(x[n], dtype) for n in ("q_u", "q_rot", "k", "v", "k_std")]
    lengths, cot = jnp.asarray(x["lengths"]), jnp.asarray(x["cot"], dtype)

    def loss(q_u, q_rot, k, v):
        out = j_rel_attention_train(q_u, q_rot, k, v, args[4], lengths, jnp.int32(seed), rate, True)
        return jnp.sum(out.astype(jnp.float32) * cot.astype(jnp.float32)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(*args[:4])
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


def _torch_run(x, seed, rate, dtype=torch.float32, fn=rel_attention_train):
    t = {n: torch.from_numpy(x[n]).to(dtype).requires_grad_(n != "k_std")
         for n in ("q_u", "q_rot", "k", "v", "k_std")}
    out = fn(t["q_u"], t["q_rot"], t["k"], t["v"], t["k_std"], torch.from_numpy(x["lengths"]),
             seed, rate)
    out.backward(torch.from_numpy(x["cot"]).to(dtype))
    assert t["k_std"].grad is None
    return out.detach().float().numpy(), [t[n].grad.float().numpy() for n in ("q_u", "q_rot", "k", "v")]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 123), (0.4, -7)])
def test_fp32_forward_and_gradients_match_jax_interpret(shape, rate, seed):
    x = _inputs(shape)
    _build.reset_launch_counts()
    out, grads = _torch_run(x, seed, rate)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: the plain version
    ref_out, ref_grads = _jax_run(x, seed, rate)
    np.testing.assert_allclose(out, ref_out, rtol=2e-5, atol=2e-5)
    for name, g, r in zip(("dq_u", "dq_rot", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_matches_jax_interpret(rate):
    x = _inputs("ragged", seed=3)
    out, grads = _torch_run(x, 11, rate, torch.bfloat16)
    ref_out, ref_grads = _jax_run(x, 11, rate, jnp.bfloat16)
    for name, g, r in zip(("out", "dq_u", "dq_rot", "dk", "dv"), [out] + grads, [ref_out] + ref_grads):
        assert np.abs(g - r).max() <= 2 ** -6 * max(1.0, np.abs(r).max()), name


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("rate,seed", [(0.1, 0), (0.5, 2 ** 31 - 1), (0.9, -2 ** 31)])
def test_keep_mask_is_bit_equal_to_the_jax_hash(shape, rate, seed):
    B, T, _ = SHAPES[shape]
    got = keep_mask(seed, B, H, T, rate).numpy()
    for b in range(B):
        for h in range(H):
            ref = np.asarray(_keep_mask(jnp.int32(seed), h, b, H, T, rate, interpret=True))
            np.testing.assert_array_equal(got[b, h], ref)
    assert abs(got.mean() - (1.0 - rate)) < 0.06


@pytest.mark.parametrize("rate,T,expected", [(0.1, 11, 0.1005859375), (0.2, 24, 0.05224609375)])
def test_bf16_probabilities_round_before_the_dropout_scale(rate, T, expected):
    """Pins the rounding points the CUDA forward relies on, bit for bit
    against the JAX kernel in interpret mode: zero queries make P = 1/T on
    every key and one-hot values read Pd out of ``out``. At these (rate, T)
    ``bf16(bf16(1/T) * bf16(1/(1-rate)))`` differs from the same product with
    an unrounded P (and, at rate 0.1, with an unrounded scale)."""
    dh, D, seed = 32, 16, 5
    x = dict(q_u=np.zeros((1, T, 1, dh), np.float32), q_rot=np.zeros((1, T, 1, D), np.float32),
             k=np.ones((1, T, 1, dh), np.float32), v=np.eye(T, dh, dtype=np.float32)[None, :, None, :],
             k_std=np.ones((T, D), np.float32), lengths=np.asarray([T], np.int32),
             cot=np.zeros((1, T, 1, dh), np.float32))
    out, _ = _torch_run(x, seed, rate, torch.bfloat16)
    ref, _ = _jax_run(x, seed, rate, jnp.bfloat16)
    np.testing.assert_array_equal(out, ref)
    keep = keep_mask(seed, 1, 1, T, rate).numpy()[0, 0]
    np.testing.assert_array_equal(out[0, :, 0, :T], np.where(keep, np.float32(expected), np.float32(0)))
    unrounded_p = torch.tensor(np.float32(1) / np.float32(T)) * torch.tensor(
        np.float32(1.0 / (1.0 - rate))).bfloat16().float()
    assert float(unrounded_p.bfloat16()) != expected


def test_zero_length_row_is_uniform_over_all_keys():
    x = _inputs("zero_len")
    out, _ = _torch_run(x, 0, 0.0)
    np.testing.assert_allclose(out[1], np.broadcast_to(x["v"][1].mean(axis=0), out[1].shape),
                               rtol=1e-5, atol=1e-5)


def test_plain_backward_equals_autograd_of_the_formula():
    """The plain version's hand-written backward against autograd of the
    naive softmax attention, fp32, dropout off."""
    x = _inputs("odd_T", seed=5)
    _, grads = _torch_run(x, 0, 0.0, fn=rel_attention_train_plain)

    def naive(q_u, q_rot, k, v, k_std, lengths, seed, rate):
        T = q_u.shape[1]
        s = (torch.einsum("bthd,bshd->bhts", q_u, k) + torch.einsum("bthD,sD->bhts", q_rot, k_std))
        s = s / np.sqrt(DH)
        mask = torch.arange(T)[None, None, None, :] < lengths[:, None, None, None]
        p = torch.softmax(torch.where(mask, s, -1e9), dim=-1)
        return torch.einsum("bhts,bshd->bthd", p, v)

    _, ref = _torch_run(x, 0, 0.0, fn=naive)
    for name, g, r in zip(("dq_u", "dq_rot", "dk", "dv"), grads, ref):
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-5, err_msg=name)


def test_same_seed_repeats_and_other_seed_differs():
    x = _inputs("ragged")
    a, _ = _torch_run(x, 5, 0.3)
    b, _ = _torch_run(x, 5, 0.3)
    c, _ = _torch_run(x, 6, 0.3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_bad_rate_raises():
    x = _inputs("ragged")
    with pytest.raises(ValueError):
        _torch_run(x, 0, 1.0)


@pytest.mark.parametrize("dh,D,dtype", [(64, 576, torch.bfloat16), (32, 520, torch.bfloat16),
                                        (32, 528, torch.float32), (32, 256, torch.float16),
                                        (96, 64, torch.bfloat16)])
def test_kernel_gate_raises_and_names_the_way_out(dh, D, dtype):
    """What the CUDA kernels do not take raises (nothing falls back to the
    plain version), and the message names ``attention_impl='xla'``: a head
    past 64 columns, q_rot past 512 (bf16 and fp32) once padded to whole
    tiles, a dtype other than bf16 and fp32. (The wrapper pads D to whole
    tiles, so D = 40 in fp32 and 48 in bf16 run; in bf16 a head and q_rot
    wider together than the dq kernel's 288-column accumulator, as 64 + 256,
    run the backward that writes dS.)"""
    z = lambda *shape: torch.zeros(*shape, dtype=dtype)  # noqa: E731
    with pytest.raises(ValueError, match="attention_impl='xla'"):
        _check_inputs(z(1, 8, 2, dh), z(1, 8, 2, D), z(1, 8, 2, dh), z(1, 8, 2, dh), z(8, D),
                      torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("T", [70, 72])
def test_bf16_backward_matches_jax_interpret_at_a_ragged_length(T):
    """All four gradients in bf16 with dropout on, at a T that is no multiple
    of the kernels' tiles, with rows of full length, length 1 and length 0:
    the contract the CUDA backward is held to on the card. 2^-6 of each
    tensor's scale (isolated bf16 rounding flips)."""
    rng = np.random.default_rng(T)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = dict(q_u=mk(3, T, H, DH), q_rot=0.25 * mk(3, T, H, D), k=mk(3, T, H, DH), v=mk(3, T, H, DH),
             k_std=mk(T, D), lengths=np.asarray([T, 1, 0], np.int32), cot=mk(3, T, H, DH))
    _, grads = _torch_run(x, 77, 0.1, torch.bfloat16)
    _, ref_grads = _jax_run(x, 77, 0.1, jnp.bfloat16)
    for name, g, r in zip(("dq_u", "dq_rot", "dk", "dv"), grads, ref_grads):
        assert np.isfinite(g).all(), name
        assert np.abs(g - r).max() <= 2 ** -6 * max(1.0, np.abs(r).max()), name
    # a row of length 1 sends gradient to its first key only; a row of length 0 to all of them
    assert not grads[2][1, 1:].any() and not grads[3][1, 1:].any()
    assert grads[3][2].any(axis=(1, 2)).all()


def test_delta_is_the_row_sum_over_the_unrounded_probabilities():
    """delta = rowsum(dP * P32) with the fp32 probabilities, as the TPU kernel
    takes it, and not rowsum(dO * O): O is built from the rounded P and is
    itself rounded. The inputs make every dP of a row nearly the same large
    number, so dS = P (dP - delta) is a small difference that the shortcut's
    bf16-level error in delta swamps; the plain backward must agree with the
    JAX kernel's VJP where the shortcut does not."""
    T, rng = 24, np.random.default_rng(9)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731
    x = dict(q_u=bf(mk(1, T, 1, DH)), q_rot=bf(0.25 * mk(1, T, 1, D)), k=bf(mk(1, T, 1, DH)),
             v=bf(1.0 + 0.02 * mk(1, T, 1, DH)), k_std=bf(mk(T, D)), lengths=np.asarray([T], np.int32),
             cot=bf(48.0 + 0.5 * mk(1, T, 1, DH)))
    out, grads = _torch_run(x, 0, 0.0, torch.bfloat16)
    _, ref_grads = _jax_run(x, 0, 0.0, jnp.bfloat16)
    tol = [2 ** -6 * max(1.0, np.abs(r).max()) for r in ref_grads]
    for name, g, r, t in zip(("dq_u", "dq_rot", "dk", "dv"), grads, ref_grads, tol):
        assert np.abs(g - r).max() <= t, name

    # the same backward with the shortcut delta, in the plain version's own arithmetic
    t = {n: torch.from_numpy(x[n]) for n in ("q_u", "q_rot", "k", "v", "k_std", "cot")}
    s = (torch.einsum("bthd,bshd->bhts", t["q_u"], t["k"])
         + torch.einsum("bthD,sD->bhts", t["q_rot"], t["k_std"])) * float(np.float32(1.0 / np.sqrt(DH)))
    p32 = torch.softmax(s, dim=-1)
    dp = torch.einsum("bthd,bshd->bhts", t["cot"], t["v"])
    delta_true = (dp * p32).sum(-1, keepdim=True)
    delta_short = (t["cot"] * torch.from_numpy(out)).sum(-1).permute(0, 2, 1)[..., None]
    assert float((delta_true - delta_short).abs().max()) > 0.2  # bf16-level error on values near 384
    ds_short = (p32 * (dp - delta_short) * float(np.float32(1.0 / np.sqrt(DH)))).bfloat16().float()
    dq_u_short = torch.einsum("bhts,bshd->bthd", ds_short, t["k"]).bfloat16().float().numpy()
    assert np.abs(dq_u_short - ref_grads[0]).max() > 4 * tol[0]
