"""PyTorch port, the E-Branchformer variants vs the JAX package on the CPU:
gated and gated_shared conv front ends, rotary positions, causal models, and
the CSGU linear after the conv (K1's ``has_csgu_linear`` rows, the ungated
CSGU conv and the GEMM's gate epilogue in their plain versions).

One seeded numpy tree feeds both packages (``torch_port_helpers.make_models``)
at a tiny size: 1 layer of 64, 2 heads, I=128, conv_dim (8, 8). The training
step of each variant is held in ``tests/test_torch_variant_steps.py``, K1
with the CSGU linear in ``tests/test_torch_variants_csgu_linear.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.interop.export_hf import export_ebranchformer_ctc
from huggingface_asr_tpu.models.fast_infer import fused_encoder_ok as j_fused_ok
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.interop.from_jax import flax_tree_from_state_dict, state_dict_from_flax
from huggingface_asr_tpu_torch.models import ebranchformer as PE
from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng, EBranchformerForCTC, init_from_scratch_
from huggingface_asr_tpu_torch.models.fast_infer import fused_encoder_ok

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
