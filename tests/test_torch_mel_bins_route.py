"""PyTorch port, the CTC kernel route at 23 and 128 mel bins against the JAX
package's, waveform to logits, on the CPU: the inputs and the reference
caveat (k) rule of ``tests/test_torch_mel_bins.py`` (split from it, whose
fixture and helpers this test shares, so that the two files run on two
workers).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.models.fast_infer import ctc_infer_fused
from huggingface_asr_tpu.ops.features import LogMelConfig as JLogMelConfig
from huggingface_asr_tpu.ops.pallas_features import PallasLogMelFrontEnd
from test_torch_mel_bins import BINS, COL3, EMPTY, LENS, _check_empty_column, _np, noise  # noqa: F401  (fixture)
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.kernels import mel as K3
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer
from huggingface_asr_tpu_torch.ops.features import LogMelConfig


@pytest.mark.parametrize("n_mel", BINS)
def test_slice_matches_jax_at_other_bin_counts(noise, n_mel):
    """The CTC kernel route, waveform to logits, on a 2-layer x 64 model (the
    model's own conv front end: K2 takes 80 bins only, on both sides): the
    port's ``MelFrontEnd`` ("highest", fused CMVN) and ``ctc_infer`` on
    ``FusedCTC`` (plain versions) against JAX's ``PallasLogMelFrontEnd`` and
    ``ctc_infer_fused(interpret=True)``. Logits within 0.05 of their scale,
    as the 80-bin route is held (test_torch_pipeline.py). At 128 bins the
    utterance whose column 3 is NaN (150 frames) has no finite logit on
    either side; the others are compared."""
    jcfg, pcfg, tree, _, pmodel = make_models(seed=1, hidden_size=64, num_attention_heads=2, intermediate_size=128,
                                              num_fbanks=n_mel, conv_dim=(64, 64))
    front = PallasLogMelFrontEnd(JLogMelConfig(num_mel_bins=n_mel, matmul_precision="highest"), interpret=True,
                                 fused_cmvn_bf16=True)
    j_feats, j_lens = front(jnp.asarray(noise), jnp.asarray(LENS))
    ref = ctc_infer_fused(tree, jcfg, j_feats, j_lens, bb=1, interpret=True)
    fused = FusedCTC(pmodel, "cpu")
    assert fused.subsample is None
    feats, feat_lens = K3.MelFrontEnd(LogMelConfig(num_mel_bins=n_mel))(torch.from_numpy(noise),
                                                                       torch.from_numpy(LENS))
    with torch.no_grad():
        out = ctc_infer(fused, feats, feat_lens)
    np.testing.assert_array_equal(out.logit_lengths.numpy(), np.asarray(ref.logit_lengths))
    g, r = out.logits.float().numpy(), _np(ref.logits)
    assert g.shape == r.shape
    _check_empty_column(n_mel, feats.float().numpy(), _np(j_feats), [150, 171, 200])
    compared = 0
    for i, n in enumerate(out.logit_lengths.tolist()):
        if n_mel in EMPTY and COL3[i] == "nan":
            assert not np.isfinite(r[i, :n]).any() and not np.isfinite(g[i, :n]).any()
            continue
        assert np.isfinite(g[i, :n]).all() and np.isfinite(r[i, :n]).all()
        d = np.abs(g[i, :n] - r[i, :n]).max()
        assert d <= 0.05 * max(1.0, float(np.abs(r[i, :n]).max())), (i, d)
        compared += 1
    assert compared == (2 if n_mel in EMPTY else 3)
