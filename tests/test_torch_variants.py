"""PyTorch port, the E-Branchformer variants vs the JAX package on the CPU:
gated and gated_shared conv front ends, rotary positions, causal models, and
the CSGU linear after the conv (K1's ``has_csgu_linear`` rows, the ungated
CSGU conv and the GEMM's gate epilogue in their plain versions).

One seeded numpy tree feeds both packages (``torch_port_helpers.make_models``)
at a tiny size: 1 layer of 64, 2 heads, I=128, conv_dim (8, 8).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.interop.export_hf import export_ebranchformer_ctc
from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel
from huggingface_asr_tpu.models.fast_infer import ctc_infer_fused
from huggingface_asr_tpu.models.fast_infer import fused_encoder_ok as j_fused_ok
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.interop.from_jax import flax_tree_from_state_dict, state_dict_from_flax
from huggingface_asr_tpu_torch.models import ebranchformer as PE
from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng, EBranchformerForCTC, init_from_scratch_
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer, fused_encoder_ok

TINY = dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=2, intermediate_size=128,
            conv_dim=(8, 8), csgu_kernel_size=7, merge_conv_kernel=7, vocab_size=30)
VARIANTS = {
    "gated": dict(context_awareness_type="gated"),
    "gated_shared": dict(context_awareness_type="gated_shared"),
    "rotary": dict(position_embeddings_type="rotary"),
    "causal": dict(is_causal=True),
}
# frames of 64 give post-conv frames of 32 and 16: whole gate frames at shared_scale_factor 4
FEATS = np.random.default_rng(11).standard_normal((3, 64, 80)).astype(np.float32)
LENS = np.asarray([64, 47, 30], np.int32)
LABELS = np.random.default_rng(12).integers(0, 30, (3, 4)).astype(np.int32)
LABEL_LENS = np.asarray([4, 2, 3], np.int32)


def _models(name, **extra):
    return make_models(seed=3, **TINY, **VARIANTS.get(name, {}), **extra)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_logits_match_flax(name):
    jcfg, pcfg, tree, jmodel, pmodel = _models(name)
    ref = jmodel.apply({"params": tree}, jnp.asarray(FEATS), jnp.asarray(LENS), deterministic=True)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(FEATS), torch.from_numpy(LENS))
    np.testing.assert_array_equal(got.logit_lengths.numpy(), np.asarray(ref.logit_lengths))
    r, g = np.asarray(ref.logits), got.logits.numpy()
    assert g.shape == r.shape
    # fp32 both sides; the products sum in another order
    assert np.abs(g - r).max() <= 1e-4 * max(1.0, np.abs(r).max()), np.abs(g - r).max()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_training_step_matches_flax(name):
    """The training forward (every dropout 0) and its backward: the loss
    within 1e-4 and the gradient norm within 1e-3, relative."""
    jcfg, pcfg, tree, jmodel, pmodel = _models(name)

    def f(p):
        return jmodel.apply({"params": p}, jnp.asarray(FEATS), jnp.asarray(LENS), labels=jnp.asarray(LABELS),
                            label_lengths=jnp.asarray(LABEL_LENS), deterministic=False,
                            rngs={"dropout": jax.random.key(1)}).loss

    j_loss, j_grads = jax.value_and_grad(f)(tree)
    j_norm = np.sqrt(sum(float(np.sum(np.square(v))) for _, v in _flat(jax.tree.map(np.asarray, j_grads))))
    pmodel.train()
    out = pmodel(torch.from_numpy(FEATS), torch.from_numpy(LENS), labels=torch.from_numpy(LABELS),
                 label_lengths=torch.from_numpy(LABEL_LENS), rng=DropoutRng(0))
    out.loss.backward()
    grads = {n: p.grad for n, p in pmodel.named_parameters()}
    assert all(g is not None for g in grads.values())
    p_norm = float(torch.sqrt(sum(g.double().square().sum() for g in grads.values())))
    np.testing.assert_allclose(float(out.loss.detach()), float(j_loss), rtol=1e-4)
    np.testing.assert_allclose(p_norm, j_norm, rtol=1e-3)
    # every gradient goes back into the Flax tree's layout
    back = dict(_flat(flax_tree_from_state_dict(grads, pcfg)))
    assert set(back) == set(k for k, _ in _flat(jax.tree.map(np.asarray, j_grads)))


@pytest.mark.parametrize("name", ["gated", "gated_shared"])
def test_gate_keys_round_trip(name):
    jcfg, pcfg, tree, _, _ = _models(name)
    ref = export_ebranchformer_ctc(tree, jcfg)
    sd = state_dict_from_flax(tree, pcfg)
    assert set(sd) == set(ref)
    assert "wav2vec2.feature_extractor.conv.1.0.conv.gate.weight" in sd
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    EBranchformerForCTC(pcfg).load_state_dict(sd, strict=True)
    back = dict(_flat(flax_tree_from_state_dict(sd, pcfg)))
    want = dict(_flat(tree))
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_gated_shared_refuses_ragged_gate_frames():
    """60 frames: 30 conv frames against 8 gate frames of 4: both packages raise."""
    jcfg, _, tree, jmodel, pmodel = _models("gated_shared")
    feats = FEATS[:, :60]
    with pytest.raises(ValueError, match="gated_shared"):
        jmodel.apply({"params": tree}, jnp.asarray(feats), jnp.asarray([60, 47, 30]), deterministic=True)
    with pytest.raises(ValueError, match="gated_shared"), torch.no_grad():
        pmodel(torch.from_numpy(feats), torch.tensor([60, 47, 30]))


def test_causal_and_rotary_take_the_plain_attention(monkeypatch):
    """Under attention_impl "pallas" a causal or rotary model never reaches
    K4 or K5, in training or in evaluation; a non-causal relative model does."""
    calls = []

    def stub(name, real):
        def f(*a, **k):
            calls.append(name)
            return real(*a, **k)
        return f

    monkeypatch.setattr(PE, "rel_attention", stub("K5", PE.rel_attention))
    monkeypatch.setattr(PE, "rel_attention_train", stub("K4", PE.rel_attention_train))
    for name, want in (("causal", []), ("rotary", []), ("gated", ["K4", "K5"])):
        calls.clear()
        _, _, _, _, pmodel = _models(name, attention_impl="pallas")
        pmodel(torch.from_numpy(FEATS), torch.from_numpy(LENS), rng=DropoutRng(0))
        with torch.no_grad():
            pmodel(torch.from_numpy(FEATS), torch.from_numpy(LENS))
        assert calls == want, (name, calls)


def test_causal_frame_depends_on_no_later_frame():
    """Changing the features after frame 40 leaves the causal model's first
    logits frames as they were (the property the streaming sessions rest on)."""
    _, _, _, _, pmodel = _models("causal")
    x = torch.from_numpy(FEATS[:1])
    y = x.clone()
    y[:, 40:] = torch.randn(1, 24, 80, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = pmodel(x, torch.tensor([64])).logits
        b = pmodel(y, torch.tensor([64])).logits
    # logits frame t reads input frames up to 4t
    torch.testing.assert_close(a[:, :9], b[:, :9], rtol=0, atol=0)
    assert not torch.equal(a[:, 12:], b[:, 12:])


def test_init_from_scratch_draws_the_gate_convs():
    _, pcfg, _, _, _ = _models("gated")
    model = init_from_scratch_(EBranchformerForCTC(pcfg), torch.Generator().manual_seed(0))
    conv = model.wav2vec2.feature_extractor.conv[1][0].conv
    for m in (conv.conv, conv.gate):
        fan_in = m.weight[0].numel()
        assert float(m.weight.abs().max()) <= 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978 + 1e-6
        assert float(m.weight.std()) == pytest.approx(np.sqrt(1.0 / fan_in), rel=0.15)
        assert not m.bias.any()


@pytest.mark.parametrize("change", [
    {}, {"context_awareness_type": "gated"}, {"context_awareness_type": "gated_shared"},
    {"csgu_use_linear_after_conv": True}, {"position_embeddings_type": "rotary"}, {"is_causal": True},
])
def test_fused_gate_matches_jax(change):
    jcfg, pcfg, _, _, _ = _models(None)
    got = fused_encoder_ok(dataclasses.replace(pcfg, **change), torch.bfloat16)
    assert got == j_fused_ok(dataclasses.replace(jcfg, **change), jnp.bfloat16), change


@pytest.mark.parametrize("extra", [
    dict(csgu_use_linear_after_conv=True),
    dict(csgu_use_linear_after_conv=True, context_awareness_type="gated", csgu_activation="gelu"),
], ids=["csgu_linear", "gated_csgu_linear_gelu"])
def test_csgu_linear_fused_matches_jax(extra):
    """K1 with the CSGU linear (plain pieces on the CPU) against the TPU
    kernel in interpret mode and against the Flax bf16 model: 0.05 of the
    logit scale on valid frames, as tests/test_pallas_layer.py holds the
    Pallas path to the Flax model."""
    jcfg, pcfg, tree, _, pmodel = make_models(seed=4, **TINY, **extra)
    fused = FusedCTC(pmodel, "cpu")
    assert "csgu_lin_w" in fused.layers[0] and fused.subsample is None
    feats, lens = FEATS[:2], LENS[:2]
    with torch.no_grad():
        got = ctc_infer(fused, torch.from_numpy(feats), torch.from_numpy(lens))
    g = got.logits.float().numpy()
    n = got.logit_lengths.numpy()
    ref_k = ctc_infer_fused(tree, jcfg, jnp.asarray(feats), jnp.asarray(lens), bb=2, interpret=True)
    ref_m = JModel(jcfg, dtype=jnp.bfloat16).apply({"params": tree}, jnp.asarray(feats), jnp.asarray(lens),
                                                   deterministic=True)
    for ref in (ref_k, ref_m):
        np.testing.assert_array_equal(n, np.asarray(ref.logit_lengths))
        r = np.asarray(ref.logits, np.float32)
        assert g.shape == r.shape
        valid = np.arange(r.shape[1])[None, :] < n[:, None]
        d = np.abs(g - r)[valid]
        assert d.max() <= 0.05 * max(1.0, np.abs(r[valid]).max()), d.max()

