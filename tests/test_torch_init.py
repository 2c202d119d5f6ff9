"""PyTorch port, the from-scratch initialiser held against the Flax init.

``models/ebranchformer.py::init_from_scratch_`` draws every parameter with
the distribution that ``EBranchformerForCTC.init`` of the JAX package gives
it. The Flax tree (three keys) is mapped onto the port's state-dict keys
(``state_dict_from_flax``), and the port's draws (three seeds) are compared
per group, each tensor divided by the std its initialiser names:

- Dense kernels, N(0, initializer_range^2);
- lecun_normal kernels (the 2-D front-end convs, the depthwise CSGU and
  merge convs, the feature projection's Dense): a normal truncated to two of
  its stds, scaled to variance 1 / fan_in.

Tolerance, sampling only: with n pooled unit-variance draws on each side, the
two means agree within 6 sqrt(2 / n), the two stds within 6 sqrt(1 / n) and
the two excess kurtoses within 6 sqrt(48 / n) (the kurtosis separates the
truncated normal, -0.63, from the normal, 0); each side's std is also within
6 sqrt(1 / (2 n)) of 1. Zero and one entries (biases, the attention's
position biases, LayerNorm scales and shifts) must be exact.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel

from huggingface_asr_tpu_torch.interop.from_jax import state_dict_from_flax
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC, init_from_scratch_

CFG = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
           conv_dim=(32, 32), conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1), vocab_size=40)
SEEDS = (0, 1, 2)
TRUNC_STD = 0.87962566103423978  # std of the standard normal truncated to [-2, 2]


def _groups(model: EBranchformerForCTC):
    """key -> ("dense" | "lecun", expected std) or ("zero" | "one", None)."""
    std = model.config.initializer_range
    out = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            key = f"{mname}.{pname}"
            if isinstance(m, nn.LayerNorm):
                out[key] = ("one" if pname == "weight" else "zero", None)
            elif pname != "weight":
                out[key] = ("zero", None)
            elif isinstance(m, nn.Linear) and mname != "wav2vec2.feature_projection.projection":
                out[key] = ("dense", std)
            else:
                out[key] = ("lecun", float(np.sqrt(1.0 / p[0].numel())))
    return out


@pytest.fixture(scope="module")
def draws():
    """(groups, [JAX state dicts], [port state dicts]) over the seeds."""
    pcfg = EBranchformerConfig(**CFG)
    jmodel = JModel(JConfig(**CFG), dtype=jnp.float32)
    x, lens = jnp.zeros((1, 64, 80), jnp.float32), jnp.asarray([64], jnp.int32)
    jax_sds, port_sds = [], []
    for seed in SEEDS:
        tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed), x, lens)["params"])
        jax_sds.append({k: v.numpy() for k, v in state_dict_from_flax(tree, pcfg).items()})
        model = init_from_scratch_(EBranchformerForCTC(pcfg), torch.Generator().manual_seed(seed))
        port_sds.append({k: v.detach().numpy().copy() for k, v in model.state_dict().items()})
    return _groups(EBranchformerForCTC(pcfg)), jax_sds, port_sds


def test_every_parameter_has_a_group_and_the_flax_shape(draws):
    groups, jax_sds, port_sds = draws
    assert set(groups) == set(jax_sds[0]) == set(port_sds[0])
    for k in groups:
        assert jax_sds[0][k].shape == port_sds[0][k].shape, k
    kinds = {g for g, _ in groups.values()}
    assert kinds == {"dense", "lecun", "zero", "one"}


def test_zero_and_one_entries_are_exact(draws):
    groups, jax_sds, port_sds = draws
    for k, (kind, _) in groups.items():
        if kind in ("zero", "one"):
            want = 0.0 if kind == "zero" else 1.0
            for sd in jax_sds + port_sds:
                assert np.all(sd[k] == want), k


def _pooled(sds, groups, kind):
    return np.concatenate([(sd[k] / s).ravel().astype(np.float64) for sd in sds
                           for k, (g, s) in groups.items() if g == kind])


def _excess_kurtosis(x):
    c = x - x.mean()
    return float(np.mean(c ** 4) / np.mean(c ** 2) ** 2 - 3.0)


@pytest.mark.parametrize("kind", ["dense", "lecun"])
def test_group_statistics_match_the_flax_init(draws, kind):
    groups, jax_sds, port_sds = draws
    j, p = _pooled(jax_sds, groups, kind), _pooled(port_sds, groups, kind)
    n = min(j.size, p.size)
    assert j.size == p.size and n > 10_000
    stats = {name: (float(f(p)), float(f(j))) for name, f in
             (("mean", np.mean), ("std", np.std), ("excess kurtosis", _excess_kurtosis))}
    print(f"\n{kind}: n={n} per side; port vs flax (unit-variance units): {stats}")
    assert abs(stats["mean"][0] - stats["mean"][1]) <= 6 * np.sqrt(2.0 / n)
    assert abs(stats["std"][0] - stats["std"][1]) <= 6 * np.sqrt(1.0 / n)
    assert abs(stats["excess kurtosis"][0] - stats["excess kurtosis"][1]) <= 6 * np.sqrt(48.0 / n)
    for side in stats["std"]:
        assert abs(side - 1.0) <= 6 * np.sqrt(0.5 / n)
    if kind == "lecun":  # truncated at two stds of the unscaled normal, on both sides
        bound = 2.0 / TRUNC_STD + 1e-5
        assert np.abs(p).max() <= bound and np.abs(j).max() <= bound


@pytest.mark.parametrize("kind", ["dense", "lecun"])
def test_each_large_tensor_matches_its_flax_std(draws, kind):
    """Tensor by tensor (those of at least 1,000 entries, pooled over the seeds)."""
    groups, jax_sds, port_sds = draws
    checked = 0
    for k, (g, s) in groups.items():
        if g != kind or jax_sds[0][k].size < 1000:
            continue
        j = np.concatenate([sd[k].ravel() for sd in jax_sds]) / s
        p = np.concatenate([sd[k].ravel() for sd in port_sds]) / s
        assert abs(p.std() - j.std()) <= 6 * np.sqrt(1.0 / p.size), k
        checked += 1
    assert checked >= 5


def test_draws_follow_the_generator():
    pcfg = EBranchformerConfig(**CFG)
    a, b, c = (init_from_scratch_(EBranchformerForCTC(pcfg), torch.Generator().manual_seed(s)).state_dict()
               for s in (5, 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head.weight"], c["lm_head.weight"])
