"""PyTorch port, the wav2vec2 contrastive objective and its gradients against
the JAX package's on the CPU, in fp32 (training with JAX's Gumbel draw, and
evaluation; once with each masked frame's first negative set to the frame
itself) and in bf16, on the tiny model of ``tests/test_torch_wav2vec2.py``
(split from it, whose fixture, helpers and tolerances these tests share, so
that the two files run on two workers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.wav2vec2_ssl import Wav2Vec2ForPreTraining as JWav2Vec2
from test_torch_wav2vec2 import LENS, _rel, tiny  # noqa: F401  (fixture)

from huggingface_asr_tpu_torch.interop.from_jax import wav2vec2_flax_tree_from_state_dict
from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng


def _norm_rel(got_tree, ref_tree):
    got, ref = jax.tree.leaves(got_tree), jax.tree.leaves(ref_tree)
    assert len(got) == len(ref)
    diff = np.sqrt(sum(float(np.sum((np.asarray(g, np.float64) - np.asarray(r, np.float64)) ** 2))
                       for g, r in zip(got, ref)))
    norm = np.sqrt(sum(float(np.sum(np.asarray(r, np.float64) ** 2)) for r in ref))
    assert norm > 0
    return diff / norm


def _objective(tiny, dtype, train, self_negatives, monkeypatch):
    jmodel, params, pmodel, feats, mask, negs, noise = tiny
    negs = negs.copy()
    if self_negatives:  # each masked frame's first negative is the frame itself: the isclose mask fires
        for b, t in zip(*np.nonzero(mask)):
            negs[b, t, 0] = t
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jm = JWav2Vec2(jmodel.config, dtype=jdtype)
    # the JAX quantizer's Gumbel draw is ``noise`` (jax.random.gumbel of key 7)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: jnp.asarray(noise).reshape(shape))

    def j_loss(p):
        out = jm.apply({"params": p}, jnp.asarray(feats).astype(jdtype), jnp.asarray(LENS), jnp.asarray(mask),
                       jnp.asarray(negs), gumbel_temperature=1.7, deterministic=not train,
                       rngs={"gumbel": jax.random.key(2), "dropout": jax.random.key(3)})
        return out.loss, {k: getattr(out, k) for k in ("contrastive_loss", "diversity_loss",
                                                        "codevector_perplexity", "num_masked")}

    (j_value, j_out), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    pmodel.zero_grad()
    out = pmodel(torch.from_numpy(feats), torch.from_numpy(LENS), torch.from_numpy(mask), torch.from_numpy(negs),
                 gumbel_temperature=1.7, rng=DropoutRng(0) if train else None,
                 gumbel_noise=torch.from_numpy(noise) if train else None, dtype=dtype)
    out.loss.backward()
    # (no gradient reaches weight_proj through the hard codes of an evaluation: zeros, as jax.grad gives)
    grads = wav2vec2_flax_tree_from_state_dict(
        {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in pmodel.named_parameters()}, pmodel.config)
    j_grads = {k: v for k, v in jax.tree.map(np.asarray, j_grads).items()}
    return out, j_out, j_value, _norm_rel(grads, j_grads)


@pytest.mark.parametrize("train,self_negatives", [(True, False), (True, True), (False, False)],
                         ids=["train", "train-self-negatives", "eval"])
def test_objective_and_gradients_match_jax_fp32(tiny, train, self_negatives, monkeypatch):
    out, j_out, j_value, grad_err = _objective(tiny, torch.float32, train, self_negatives, monkeypatch)
    assert int(out.num_masked) == int(j_out["num_masked"]) > 0
    for name in ("contrastive_loss", "diversity_loss", "codevector_perplexity"):
        assert _rel(getattr(out, name), j_out[name]) <= 1e-5, name
    assert _rel(out.loss, j_value) <= 1e-5
    assert grad_err <= 1e-5, grad_err
    if self_negatives:  # a masked frame's own negative drops out of its softmax: the loss moves
        plain, _, _, _ = _objective(tiny, torch.float32, train, False, monkeypatch)
        assert abs(float(plain.contrastive_loss) - float(out.contrastive_loss)) > 1e-3


def test_objective_and_gradients_match_jax_bf16(tiny, monkeypatch):
    out, j_out, j_value, grad_err = _objective(tiny, torch.bfloat16, True, True, monkeypatch)
    assert int(out.num_masked) == int(j_out["num_masked"]) > 0
    for name in ("contrastive_loss", "codevector_perplexity"):
        assert _rel(getattr(out, name), j_out[name]) <= 2e-3, name
    assert _rel(out.loss, j_value) <= 2e-3
    assert grad_err <= 5e-2, grad_err
