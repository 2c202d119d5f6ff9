"""PyTorch port, the E-Branchformer variants' training forward and backward
against the JAX package on the CPU (every dropout 0), on the tiny models of
``tests/test_torch_variants.py`` (split from it, whose inputs and helpers
these tests share, so that the files run on separate workers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_variants import FEATS, LENS, VARIANTS, _flat, _models

from huggingface_asr_tpu_torch.interop.from_jax import flax_tree_from_state_dict
from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng

LABELS = np.random.default_rng(12).integers(0, 30, (3, 4)).astype(np.int32)
LABEL_LENS = np.asarray([4, 2, 3], np.int32)


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
