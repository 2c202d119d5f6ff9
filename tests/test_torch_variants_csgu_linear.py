"""PyTorch port, K1 with the CSGU linear after the conv (plain pieces on the
CPU) against the TPU kernel in interpret mode and the Flax bf16 model, on the
tiny models of ``tests/test_torch_variants.py`` (split from it, whose inputs
these tests share, so that the files run on separate workers).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel
from huggingface_asr_tpu.models.fast_infer import ctc_infer_fused
from test_torch_variants import FEATS, LENS, TINY
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer


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
