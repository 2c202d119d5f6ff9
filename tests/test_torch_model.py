"""PyTorch port, model level vs the JAX package: configs, lengths, the
checkpoint bridge, the fp32 model, the bf16 fused path and greedy decoding."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.interop.export_hf import export_ebranchformer_ctc
from huggingface_asr_tpu.models import ebranchformer as JE
from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.ops.lengths import conv_stack_output_length as j_stack_length
from huggingface_asr_tpu.models.fast_infer import ctc_infer_fused
from huggingface_asr_tpu.models.fast_infer import fused_encoder_ok as j_fused_ok
from huggingface_asr_tpu.ops.ctc import ctc_greedy_decode as j_greedy
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.interop.from_jax import state_dict_from_flax
from huggingface_asr_tpu_torch.models import ebranchformer as PE
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig, parse_dtype
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer, fused_encoder_ok
from huggingface_asr_tpu_torch.ops.ctc import ctc_greedy_decode, tokens_to_lists
from huggingface_asr_tpu_torch.ops.lengths import conv_stack_output_length

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T_IN = 4, 100
LENS = np.asarray([100, 83, 57, 30], np.int32)


@pytest.fixture(scope="module")
def models():
    return make_models(seed=0)


@pytest.fixture(scope="module")
def feats():
    return np.random.default_rng(5).standard_normal((B, T_IN, 80)).astype(np.float32)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "ebranchformer_*.json"))))
def test_configs_load_like_jax(path):
    with open(path) as f:
        d = json.load(f)
    assert dataclasses.asdict(EBranchformerConfig.from_dict(d)) == dataclasses.asdict(JConfig.from_dict(d))


def test_parse_dtype():
    assert parse_dtype("bfloat16") is torch.bfloat16 and parse_dtype("float32") is torch.float32


@pytest.mark.parametrize("n", [0, 1, 7, 64, 998, 1998])
def test_length_helpers_match_jax(models, n):
    jcfg, pcfg = models[0], models[1]
    assert PE.feat_extract_output_frames(pcfg, n) == JE.feat_extract_output_frames(jcfg, n)
    assert PE.feat_extract_output_lengths(pcfg, n) == JE.feat_extract_output_lengths(jcfg, n)
    t = torch.tensor([n, n + 3])
    np.testing.assert_array_equal(PE.feat_extract_output_lengths(pcfg, t).numpy(),
                                  JE.feat_extract_output_lengths(jcfg, np.asarray([n, n + 3])))


@pytest.mark.parametrize("causal", [False, True])
def test_conv_stack_length_matches_jax(causal):
    for n in (1, 5, 64, 999):
        assert conv_stack_output_length(n, (3, 3), (2, 2), (1, 1), causal) == j_stack_length(
            n, (3, 3), (2, 2), (1, 1), causal)


def test_state_dict_matches_export(models):
    jcfg, pcfg, tree, _, _ = models
    ref = export_ebranchformer_ctc(tree, jcfg)
    got = state_dict_from_flax(tree, pcfg)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    EBranchformerForCTC(pcfg).load_state_dict(got, strict=True)


def test_fp32_model_matches_flax(models, feats):
    jcfg, pcfg, tree, jmodel, pmodel = models
    ref = jmodel.apply({"params": tree}, jnp.asarray(feats), jnp.asarray(LENS), deterministic=True)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(feats), torch.from_numpy(LENS))
    np.testing.assert_array_equal(got.logit_lengths.numpy(), np.asarray(ref.logit_lengths))
    r, g = np.asarray(ref.logits), got.logits.numpy()
    assert g.shape == r.shape
    # fp32 both sides; the fp32 products sum in another order
    assert np.abs(g - r).max() <= 1e-4 * max(1.0, np.abs(r).max())


def test_bf16_ctc_infer_matches_fused_interpret(models, feats):
    """Plain bf16 fused path (CPU) vs ctc_infer_fused(interpret=True) with
    ragged lengths; tolerance 0.05 of the scale on valid frames, as
    tests/test_pallas_layer.py:63 holds the Pallas path to the Flax model."""
    jcfg, pcfg, tree, _, pmodel = models
    ref = ctc_infer_fused(tree, jcfg, jnp.asarray(feats), jnp.asarray(LENS), bb=2, interpret=True)
    with torch.no_grad():
        got = ctc_infer(FusedCTC(pmodel, "cpu"), torch.from_numpy(feats), torch.from_numpy(LENS))
    lens = np.asarray(ref.logit_lengths)
    np.testing.assert_array_equal(got.logit_lengths.numpy(), lens)
    r = np.asarray(ref.logits, np.float32)
    g = got.logits.float().numpy()
    assert g.shape == r.shape and got.logits.dtype == torch.bfloat16
    valid = np.arange(r.shape[1])[None, :] < lens[:, None]
    d = np.abs(g - r)[valid]
    assert d.max() <= 0.05 * max(1.0, np.abs(r[valid]).max()), d.max()


def test_fused_gate(models):
    jcfg, pcfg = models[0], models[1]
    assert fused_encoder_ok(pcfg, torch.bfloat16)
    assert not fused_encoder_ok(pcfg, torch.float32)
    # the kernels' own limits: heads past 64 columns, one head of 128
    for change in ({"hidden_size": 576, "num_attention_heads": 18}, {"num_attention_heads": 1}):
        assert not fused_encoder_ok(dataclasses.replace(pcfg, **change), torch.bfloat16), change
    # elsewhere the port admits what the JAX package's gate admits: a gated
    # front end runs as the model's own modules, the CSGU linear as K1's
    # ungated conv and gate epilogue
    for change in ({"position_embeddings_type": "rotary"}, {"use_macaron_ff": False},
                   {"csgu_use_linear_after_conv": True}, {"context_awareness_type": "gated"}):
        got = fused_encoder_ok(dataclasses.replace(pcfg, **change), torch.bfloat16)
        assert got == j_fused_ok(dataclasses.replace(jcfg, **change), jnp.bfloat16), change
    assert fused_encoder_ok(dataclasses.replace(pcfg, context_awareness_type="gated"), torch.bfloat16)
    assert fused_encoder_ok(dataclasses.replace(pcfg, conv_dim=(32, 32), num_attention_heads=8), torch.bfloat16)
    with pytest.raises(ValueError):
        FusedCTC(EBranchformerForCTC(dataclasses.replace(pcfg, num_attention_heads=1)), "cpu")


def test_greedy_decode_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 40, 6)).astype(np.float32)
    logits[:, ::3, 2] += 3.0  # repeats and blanks to collapse
    logits[:, 1::4, -1] += 4.0
    lens = np.asarray([40, 25, 0], np.int32)
    jt, jl = j_greedy(jnp.asarray(logits), jnp.asarray(lens), blank_id=-1)
    pt, pl = ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens), blank_id=-1)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert tokens_to_lists(pt.numpy(), pl.numpy())[2] == []


def test_random_init_is_seeded():
    cfg = EBranchformerConfig(**{**dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                                        intermediate_size=128, conv_dim=(8, 8), vocab_size=10)})
    a = PE.init_random_(EBranchformerForCTC(cfg), torch.Generator().manual_seed(3))
    b = PE.init_random_(EBranchformerForCTC(cfg), torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
