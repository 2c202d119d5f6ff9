"""PyTorch port, the training attention (K4) in fp32 at the 512-wide
config's q_rot width, vs the JAX package on the CPU.

On the card the fp32 kernels of ``csrc/rel_attention_train.cu`` take q_rot
up to 512 columns, as the bf16 ones do (``tests/test_torch_cuda.py`` holds
them to their plain version there). Here, on CPU tensors, the port's plain
version runs: against ``rel_attention_train(..., interpret=True)`` of the
JAX package at (dh 64, q_rot 512) and (dh 40, q_rot 312), rtol/atol 2e-5 on
the output and 2e-4 on the four gradients (``test_torch_train_attention.py``'s
fp32 tolerances); the BEST-RQ objective and its gradients at the 90m
config's widths (two layers, 48 mel frames) with the port's
``attention_impl="pallas"`` against JAX's "xla", within 1e-4 of the scale;
and the gate and the fp32 kernels' shared-memory layouts at every width the
gate admits.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.bestrq import BestRQForPreTraining as JBestRQ
from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.ops.masking import compute_mask_indices as j_mask_indices
from test_torch_train_attention import _jax_run, _torch_run

from huggingface_asr_tpu_torch.interop.from_jax import (
    pretraining_flax_tree_from_state_dict,
    pretraining_state_dict_from_flax,
)
from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels.train_attention import _check_inputs, padded_widths
from huggingface_asr_tpu_torch.models import bestrq as PB
from huggingface_asr_tpu_torch.models import ebranchformer as model_module
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "huggingface_asr_tpu_torch", "csrc")


def _k4_inputs(dh, D, seed, B=3, T=24, H=2):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q_u=mk(B, T, H, dh), q_rot=0.25 * mk(B, T, H, D), k=mk(B, T, H, dh), v=mk(B, T, H, dh),
                k_std=mk(T, D), lengths=np.asarray([T, 1, 0], np.int32), cot=mk(B, T, H, dh))


def _hold_to_jax(x, seed, rate):
    _build.reset_launch_counts()
    out, grads = _torch_run(x, seed, rate)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: the plain version
    ref_out, ref_grads = _jax_run(x, seed, rate)
    np.testing.assert_allclose(out, ref_out, rtol=2e-5, atol=2e-5)
    for name, g, r in zip(("dq_u", "dq_rot", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4, err_msg=name)
    return grads


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fp32_at_q_rot_512_matches_jax_interpret(rate):
    """(dh 64, q_rot 512), rows of length T, 1 and 0."""
    grads = _hold_to_jax(_k4_inputs(64, 512, seed=int(rate * 10) + 64), 9, rate)
    # a row of length 1 sends gradient to its first key only
    assert not grads[2][1, 1:].any() and not grads[3][1, 1:].any()


def test_fp32_at_a_padded_head_and_q_rot_matches_jax_interpret():
    """(dh 40, q_rot 312): on the card the wrapper pads them to (64, 320)."""
    assert padded_widths(40, 312, torch.float32) == (64, 320)
    _hold_to_jax(_k4_inputs(40, 312, seed=40), 21, 0.1)


def test_bestrq_objective_in_fp32_on_the_k4_route_matches_jax():
    """The 90m config's widths (512, 8 heads of 64, I 2,048, codebook 8,192)
    at two layers: the port's training forward (``rng`` given, every dropout
    0) with ``attention_impl="pallas"`` reaches ``rel_attention_train`` in
    each layer (on CPU tensors its plain version); JAX's objective with
    "xla". Loss and the gradients' norm of differences within 1e-4."""
    with open(os.path.join(REPO, "configs", "ebranchformer_90m_ssl.json")) as f:
        d = {**json.load(f), "num_hidden_layers": 2, "vocab_size": 30}
    d.update({k: 0.0 for k in ("hidden_dropout", "attention_dropout", "activation_dropout", "csgu_conv_dropout",
                               "final_dropout")})
    B, T_MEL, T_ENC = 2, 48, 12
    lens = np.asarray([48, 37], np.int32)
    feats = np.random.default_rng(0).standard_normal((B, T_MEL, 80)).astype(np.float32)
    mask = j_mask_indices((B, T_ENC), 0.5, 3, rng=np.random.default_rng(2))
    jmodel = JBestRQ(JConfig.from_dict({**d, "attention_impl": "xla"}))
    init = jax.jit(lambda f, n, m: jmodel.init({"params": jax.random.key(0), "mask_noise": jax.random.key(1)}, f, n, m))
    variables = jax.tree.map(np.asarray, init(jnp.asarray(feats), jnp.asarray(lens), jnp.asarray(mask)))
    noise = np.asarray(0.1 * jax.random.normal(jax.random.key(2), (B, T_ENC, d["hidden_size"]), jnp.float32))

    def j_loss(params):
        out = jmodel.apply({"params": params, "buffers": variables["buffers"]}, jnp.asarray(feats), jnp.asarray(lens),
                           jnp.asarray(mask), noise_rng=jax.random.key(2), deterministic=True)
        return out.loss

    j_value, j_grads = jax.jit(jax.value_and_grad(j_loss))(variables["params"])

    cfg = EBranchformerConfig.from_dict({**d, "attention_impl": "pallas"})
    pmodel = PB.BestRQForPreTraining(cfg)
    pmodel.load_state_dict(pretraining_state_dict_from_flax(variables, cfg), strict=True)
    calls = []
    kernel_fn = model_module.rel_attention_train

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return kernel_fn(*args, **kwargs)

    model_module.rel_attention_train = counted
    try:
        out = pmodel(torch.from_numpy(feats), torch.from_numpy(lens), torch.from_numpy(mask),
                     mask_noise=torch.from_numpy(noise), rng=DropoutRng(5))
        out.loss.backward()
    finally:
        model_module.rel_attention_train = kernel_fn
    assert calls == [(B, T_ENC, 8, 512)] * 2  # q_rot of every layer, 512 wide
    loss = float(out.loss.detach())
    assert abs(loss - float(j_value)) <= 1e-4 * abs(float(j_value))
    grads = {n: p.grad for n, p in pmodel.named_parameters()}
    got = jax.tree.leaves(pretraining_flax_tree_from_state_dict(grads, cfg)["params"])
    ref = jax.tree.leaves(jax.tree.map(np.asarray, j_grads))
    diff = np.sqrt(sum(float(np.sum((g - r) ** 2)) for g, r in zip(got, ref)))
    norm = np.sqrt(sum(float(np.sum(r ** 2)) for r in ref))
    assert norm > 0 and diff <= 1e-4 * norm, (diff, norm)


# The fp32 kernels' shared-memory bytes, as fwd_smem, dkv_smem and dq_smem of
# csrc/rel_attention_train.cu compute them (change the two together): rings of
# two stages, each a 64-column chunk of both operands (64 rows each), plus the
# forward's v tile and one 64 x 64 tile of Pd or dS; dq's ring of three stages,
# each 64 rows of dS by 32 keys and 32 key rows of 128 columns; rows padded by
# 16 bytes. None depends on q_rot: the rings stream [q_u | q_rot] and
# [k | k_std] at any width.
SM_SMEM, BLOCK_RESERVED = 233472, 1024  # an H100 SM's 228 KB of shared memory; 1 KB of it reserved a block


def _consts():
    with open(os.path.join(CSRC, "rel_attention_train.cu")) as f:
        src = f.read()
    ints = {name: int(val) for name, val in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    return {k: ints[k] for k in ("BM", "BN", "KC", "QC", "DKC", "DQ_STAGES")}


def _layouts(dh, c):
    ldc, ldp, ldq = c["KC"] + 4, c["BN"] + 4, c["QC"] + 4
    fwd = 4 * (2 * (c["BM"] + c["BN"]) * ldc + c["BN"] * (dh + 4) + c["BM"] * ldp)
    dkv = 4 * (2 * (c["BN"] + c["BM"]) * ldc + c["BN"] * ldp)
    dq = 4 * (c["DQ_STAGES"] * (c["BM"] * (c["DKC"] + 4) + c["DKC"] * ldq))
    return {"fwd": fwd, "dkv": dkv, "dq": dq}


def test_fp32_gate_and_the_kernels_layouts_at_every_q_rot_it_admits():
    assert padded_widths(64, 512, torch.float32) == (64, 512)
    assert padded_widths(64, 520, torch.float32) is None
    z = lambda *shape: torch.zeros(*shape)  # noqa: E731
    with pytest.raises(ValueError, match=r"D <= 512.*attention_impl='xla'"):
        _check_inputs(z(1, 8, 2, 64), z(1, 8, 2, 528), z(1, 8, 2, 64), z(1, 8, 2, 64), z(8, 528),
                      torch.zeros(1, dtype=torch.int32))
    consts = _consts()
    with open(os.path.join(CSRC, "attention_common.cuh")) as f:
        max_smem = int(re.search(r"constexpr size_t MAX_SMEM = (\d+);", f.read()).group(1))
    assert max_smem == 232448
    for dh in (32, 64):
        for D in range(16, 513, 16):
            assert padded_widths(dh, D, torch.float32) == (dh, D)
            sizes = _layouts(dh, consts)
            assert max(sizes.values()) <= max_smem, (dh, D, sizes)
    # the widest head: every kernel leaves room for two blocks an SM, at q_rot 512 as at 16
    sizes = _layouts(64, consts)
    assert sizes == {"fwd": 104448, "dkv": 87040, "dq": 78336}
    for name, n in sizes.items():
        assert 2 * (n + BLOCK_RESERVED) <= SM_SMEM, (name, n)
