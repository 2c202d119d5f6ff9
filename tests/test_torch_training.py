"""PyTorch port, training path vs the JAX package on the CPU.

Same numpy inputs through the JAX function and its counterpart: the model's
loss and every parameter gradient, the CTC loss, SpecAugment's apply halves
on the same draws, the schedules, the optimizer against optax, the guard,
checkpoints, the checkpoint bridge's inverse, and the host-side data copies.
Five trainer steps against the JAX ``CTCTrainer`` are in
``tests/test_torch_trainer_steps.py``.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import huggingface_asr_tpu.ops.pallas_train_attention as j_train_attention
from huggingface_asr_tpu.data import bucketing as j_bucketing
from huggingface_asr_tpu.data import collator as j_collator
from huggingface_asr_tpu.data import synthetic_speech as j_speech
from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel
from huggingface_asr_tpu.ops.ctc import ctc_forced_alignment_log_prob as j_forced_log_prob
from huggingface_asr_tpu.ops.ctc import ctc_loss as j_ctc_loss
from huggingface_asr_tpu.training import optim as j_optim
from huggingface_asr_tpu.utils import metrics as j_metrics
from torch_port_helpers import make_models

j_aug = importlib.import_module("huggingface_asr_tpu.ops.spec_augment")  # the package re-exports a function of that name

from huggingface_asr_tpu_torch.data import bucketing, collator, synthetic_speech
from huggingface_asr_tpu_torch.data.prefetch import PrefetchIterator, pinned_device_put
from huggingface_asr_tpu_torch.interop.from_jax import flax_tree_from_state_dict, state_dict_from_flax
from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import (
    DropoutRng,
    EBranchformerForCTC,
    dropout_apply,
    init_random_,
    relative_positional_embeddings,
)
from huggingface_asr_tpu_torch.ops import spec_augment as aug
from huggingface_asr_tpu_torch.ops.ctc import ctc_forced_alignment_log_prob, ctc_loss
from huggingface_asr_tpu_torch.training.loop import CTCTrainer, TrainerConfig
from huggingface_asr_tpu_torch.training.model_factory import checkpoint_steps, load_ctc_model, save_params
from huggingface_asr_tpu_torch.training.optim import AdamW, OptimizerConfig, freeze_mask, make_schedule
from huggingface_asr_tpu_torch.training.train_state import TrainState
from huggingface_asr_tpu_torch.utils import metrics
from huggingface_asr_tpu_torch.utils.logging_utils import MetricsLogger

TINY = dict(
    hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
    conv_dim=(8, 8), conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1),
    csgu_kernel_size=7, merge_conv_kernel=7, vocab_size=30,
)
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  csgu_conv_dropout=0.0, final_dropout=0.0)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


# ------------------------------------------------------------ the model's loss

@pytest.fixture(scope="module")
def loss_and_grads():
    """Training forward, all dropouts 0, attention_impl='pallas': the JAX model
    through its kernel in interpret mode, the port through its plain version."""
    jcfg, pcfg, tree, _, _ = make_models(seed=1)
    jcfg = dataclasses.replace(jcfg, attention_impl="pallas")
    pcfg = dataclasses.replace(pcfg, attention_impl="pallas")
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((3, 64, 80)).astype(np.float32)
    lens = np.asarray([64, 47, 30], np.int32)
    labels = rng.integers(0, 50, (3, 4)).astype(np.int32)
    llens = np.asarray([4, 2, 3], np.int32)

    jmodel = JModel(jcfg, dtype=jnp.float32)

    def f(p):
        return jmodel.apply({"params": p}, jnp.asarray(feats), jnp.asarray(lens),
                            labels=jnp.asarray(labels), label_lengths=jnp.asarray(llens),
                            deterministic=False, rngs={"dropout": jax.random.key(1)}).loss

    orig = j_train_attention.rel_attention_train
    j_train_attention.rel_attention_train = lambda *a: orig(*a, True)
    try:
        j_loss, j_grads = jax.value_and_grad(f)(tree)
    finally:
        j_train_attention.rel_attention_train = orig

    model = EBranchformerForCTC(pcfg)
    model.load_state_dict(state_dict_from_flax(tree, pcfg), strict=True)
    _build.reset_launch_counts()
    out = model(torch.from_numpy(feats), torch.from_numpy(lens), labels=torch.from_numpy(labels),
                label_lengths=torch.from_numpy(llens), rng=DropoutRng(0))
    out.loss.backward()
    assert sum(_build.LAUNCHES.values()) == 0
    grads = flax_tree_from_state_dict({n: p.grad for n, p in model.named_parameters()}, pcfg)
    return float(j_loss), dict(_flat(jax.tree.map(np.asarray, j_grads))), float(out.loss), dict(_flat(grads))


def test_model_loss_matches_flax(loss_and_grads):
    j_loss, _, p_loss, _ = loss_and_grads
    assert np.isfinite(p_loss)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-4)


def test_model_gradients_match_flax(loss_and_grads):
    """Every parameter gradient, rtol 5e-3 / atol 5e-4 (the tolerance the JAX
    package holds its kernel path to its XLA path)."""
    _, j_grads, _, p_grads = loss_and_grads
    assert set(j_grads) == set(p_grads)
    for name in sorted(j_grads):
        np.testing.assert_allclose(p_grads[name], j_grads[name], rtol=5e-3, atol=5e-4, err_msg=name)


def test_eval_forward_with_shift_kernel_matches_flax():
    """Inference, attention_impl='pallas': the port's shift-form core (plain
    on the CPU) against the Flax model's XLA path (same math)."""
    jcfg, pcfg, tree, jmodel, _ = make_models(seed=3)
    feats = np.random.default_rng(4).standard_normal((2, 64, 80)).astype(np.float32)
    lens = np.asarray([64, 41], np.int32)
    ref = jmodel.apply({"params": tree}, jnp.asarray(feats), jnp.asarray(lens), deterministic=True)
    model = EBranchformerForCTC(dataclasses.replace(pcfg, attention_impl="pallas")).eval()
    model.load_state_dict(state_dict_from_flax(tree, pcfg), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(lens))
    r = np.asarray(ref.logits)
    assert np.abs(got.logits.numpy() - r).max() <= 1e-4 * max(1.0, np.abs(r).max())


def test_relative_positional_embeddings_match_flax():
    from huggingface_asr_tpu.models.ebranchformer import relative_positional_embeddings as j_table

    np.testing.assert_array_equal(relative_positional_embeddings(13, 32).numpy(), np.asarray(j_table(13, 32)))


def test_training_forward_draws_dropout_and_repeats():
    cfg = EBranchformerConfig(**TINY)
    model = init_random_(EBranchformerForCTC(cfg), torch.Generator().manual_seed(0), matrix_std=cfg.initializer_range)
    feats = torch.randn(2, 40, 80, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([40, 31], dtype=torch.int32)
    a = model(feats, lens, rng=DropoutRng(5)).logits
    b = model(feats, lens, rng=DropoutRng(5)).logits
    c = model(feats, lens, rng=DropoutRng(6)).logits
    d = model(feats, lens).logits
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_dropout_apply_is_inverted_dropout():
    x = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
    keep = np.random.default_rng(1).random((4, 5)) >= 0.3
    ref = jnp.where(jnp.asarray(keep), jnp.asarray(x) / 0.7, 0.0)
    got = dropout_apply(torch.from_numpy(x), torch.from_numpy(keep), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


# ------------------------------------------------------------------- CTC loss

def _ctc_case():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 12, 7)).astype(np.float32)
    logit_lengths = np.asarray([12, 9, 12, 3], np.int32)
    labels = np.asarray([[1, 2, 2, 3, 0], [4, 0, 0, 0, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    label_lengths = np.asarray([4, 1, 0, 5], np.int32)  # row 2 empty, row 3 infeasible
    return logits, logit_lengths, labels, label_lengths


def test_ctc_loss_values_match_jax():
    logits, tl, labels, ll = _ctc_case()
    ref = np.asarray(j_ctc_loss(jnp.asarray(logits), jnp.asarray(tl), jnp.asarray(labels),
                                jnp.asarray(ll), reduction="none"))
    got = ctc_loss(torch.from_numpy(logits), torch.from_numpy(tl), torch.from_numpy(labels),
                   torch.from_numpy(ll), reduction="none").numpy()
    np.testing.assert_allclose(got[:3], ref[:3], rtol=1e-5, atol=1e-5)
    # no alignment exists: the stand-in for -inf, 1e9, on both sides
    assert ref[3] == 1e9 and got[3] == 1e9


def test_ctc_forced_alignment_log_prob_matches_jax():
    """log P(labels | logits) per example: the negated per-example loss on
    both sides, -1e9 where no alignment exists."""
    logits, tl, labels, ll = _ctc_case()
    ref = np.asarray(j_forced_log_prob(jnp.asarray(logits), jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll)))
    got = ctc_forced_alignment_log_prob(torch.from_numpy(logits), torch.from_numpy(tl), torch.from_numpy(labels),
                                        torch.from_numpy(ll)).numpy()
    np.testing.assert_allclose(got[:3], ref[:3], rtol=1e-5, atol=1e-5)
    assert ref[3] == -1e9 and got[3] == -1e9


def test_ctc_loss_infeasible_row_gives_finite_gradients():
    """As in the JAX package, a row without an alignment leaves the batch's
    gradient finite (its own row's is zero here), so the step is not lost."""
    logits, tl, labels, ll = _ctc_case()
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = ctc_loss(x, torch.from_numpy(tl), torch.from_numpy(labels), torch.from_numpy(ll))
    loss.backward()
    ref = j_ctc_loss(jnp.asarray(logits), jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll))
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
    assert bool(torch.isfinite(x.grad).all()) and float(x.grad[3].abs().max()) == 0.0
    assert float(x.grad[:3].abs().max()) > 0.0


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_ctc_loss_reductions_and_gradient_match_jax(reduction):
    logits, tl, labels, ll = (a[:3] for a in _ctc_case())  # the feasible rows
    j_args = (jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll))
    ref, ref_grad = jax.value_and_grad(
        lambda x: j_ctc_loss(x, *j_args, reduction=reduction))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_loss(x, torch.from_numpy(tl), torch.from_numpy(labels), torch.from_numpy(ll),
                   reduction=reduction)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- SpecAugment

def _spec_inputs():
    rng = np.random.default_rng(0)
    return rng.standard_normal((4, 60, 80)).astype(np.float32), np.asarray([60, 44, 9, 27], np.int32)


def _jax_warp_draws(key, length, window):
    r_center, r_shift = jax.random.split(key)
    center = jax.random.randint(r_center, (), window, jnp.maximum(length - window, window + 1))
    return int(center), int(center + jax.random.randint(r_shift, (), -window, window) + 1)


def _jax_mask_draws(key, B, num_mask, lo, hi, size):
    r_len, r_pos = jax.random.split(key)
    widths = jax.random.randint(r_len, (B, num_mask), lo, jnp.maximum(hi, lo + 1))
    bound = jnp.maximum(size - jnp.max(widths, axis=1, keepdims=True), 1)
    return np.asarray(jax.random.randint(r_pos, (B, num_mask), 0, bound)), np.asarray(widths)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_time_warp_apply_matches_jax_on_the_same_draws(seed):
    x, lengths = _spec_inputs()
    keys = jax.random.split(jax.random.key(seed), len(lengths))
    draws = [_jax_warp_draws(k, jnp.asarray(n), 5) for k, n in zip(keys, lengths)]
    ref = jax.vmap(j_aug._time_warp_one, in_axes=(0, 0, 0, None))(keys, jnp.asarray(x), jnp.asarray(lengths), 5)
    got = aug.apply_time_warp(torch.from_numpy(x), torch.from_numpy(lengths),
                              torch.tensor([d[0] for d in draws]), torch.tensor([d[1] for d in draws]), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[2], x[2])  # too short to warp
    np.testing.assert_array_equal(got.numpy()[1, 44:], x[1, 44:])  # padding untouched


@pytest.mark.parametrize("axis,size,num_mask", [(2, 80, 2), (1, 60, 5)])
def test_mask_apply_matches_jax_on_the_same_draws(axis, size, num_mask):
    x, _ = _spec_inputs()
    key = jax.random.key(7)
    lo, hi = jnp.int32(0), jnp.int32(27 if axis == 2 else 6)
    ref = j_aug._mask_along_axis(key, jnp.asarray(x), lo, hi, num_mask, axis)
    positions, widths = _jax_mask_draws(key, 4, num_mask, lo, hi, size)
    got = aug.apply_masks(torch.from_numpy(x), torch.from_numpy(positions), torch.from_numpy(widths), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_spec_augment_composition_matches_jax_on_the_same_draws():
    """The whole transform: warp, frequency masks, time masks with widths from
    the valid length, padding restored."""
    x, lengths = _spec_inputs()
    cfg_j, cfg_p = j_aug.SpecAugmentConfig(), aug.SpecAugmentConfig()
    key = jax.random.key(11)
    ref = np.asarray(j_aug.spec_augment(key, jnp.asarray(x), jnp.asarray(lengths), cfg_j))
    r_warp, r_freq, r_time = jax.random.split(key, 3)
    draws = [_jax_warp_draws(k, jnp.asarray(n), 5) for k, n in zip(jax.random.split(r_warp, 4), lengths)]
    t, tl = torch.from_numpy(x), torch.from_numpy(lengths)
    y = aug.apply_time_warp(t, tl, torch.tensor([d[0] for d in draws]), torch.tensor([d[1] for d in draws]), 5)
    y = aug.apply_masks(y, *map(torch.from_numpy, _jax_mask_draws(r_freq, 4, 2, jnp.int32(0), jnp.int32(27), 80)), 2)
    lo, hi = aug.time_mask_width_bounds(tl, cfg_p)
    y = aug.apply_masks(y, *map(torch.from_numpy, _jax_mask_draws(
        r_time, 4, 5, jnp.asarray(lo.numpy(), jnp.int32), jnp.asarray(hi.numpy(), jnp.int32), 60)), 1)
    valid = torch.arange(60)[None, :] < tl[:, None]
    got = torch.where(valid[:, :, None], y, t).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_spec_augment_draws_are_seeded_and_in_range():
    x, lengths = _spec_inputs()
    t, tl = torch.from_numpy(x), torch.from_numpy(lengths)
    a = aug.spec_augment(torch.Generator().manual_seed(3), t, tl)
    b = aug.spec_augment(torch.Generator().manual_seed(3), t, tl)
    c = aug.spec_augment(torch.Generator().manual_seed(4), t, tl)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[1, 44:], t[1, 44:])
    center, warped = aug.draw_time_warp(torch.Generator().manual_seed(0), torch.tensor([60] * 200), 5)
    assert int(center.min()) >= 5 and int(center.max()) < 55
    assert int((warped - center).min()) >= -4 and int((warped - center).max()) <= 5
    pos, wid = aug.draw_masks(torch.Generator().manual_seed(0), 200, 2, 0, 27, 80, "cpu")
    assert int(wid.min()) >= 0 and int(wid.max()) < 27 and int((pos + wid).max()) <= 80


# ------------------------------------------------------- schedules, optimizer

@pytest.mark.parametrize("kind", ["linear", "cosine", "constant", "inverse_sqrt"])
def test_schedule_matches_optax(kind):
    kw = dict(learning_rate=2e-3, lr_scheduler_type=kind, warmup_steps=10, total_steps=50)
    ref, got = j_optim.make_schedule(j_optim.OptimizerConfig(**kw)), make_schedule(OptimizerConfig(**kw))
    for step in (0, 9, 10, 11, 30, 49, 50):
        # atol: fp32 cosine near its zero, 1e-6 of the peak rate
        np.testing.assert_allclose(float(got(step)), float(ref(step)), rtol=1e-6, atol=2e-9,
                                   err_msg=f"{kind} @ {step}")
    assert float(got(0)) == 0.0


def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"dense.weight": (6, 4), "dense.bias": (6,), "ln.weight": (4,), "pos_bias_u": (2, 3),
              "conv.weight": (4, 1, 3)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    scales = (0.1, 30.0, 0.5, 0.2)  # step 2's gradients are clipped (norm > 5)
    grads = [{n: (rng.standard_normal(s) * k).astype(np.float32) for n, s in shapes.items()} for k in scales]
    return params, grads


@pytest.mark.parametrize("accumulate", [1, 2])
def test_optimizer_steps_match_optax(accumulate):
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10, weight_decay=1e-2,
              gradient_accumulation_steps=accumulate)
    params, grads = _opt_case()
    tx = j_optim.make_optimizer(j_optim.OptimizerConfig(**kw))
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    t_params = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    opt = AdamW(t_params.items(), OptimizerConfig(**kw))
    assert float(sum(np.linalg.norm(g) ** 2 for g in grads[1].values()) ** 0.5) > 5.0
    for g in grads:
        updates, j_state = tx.update(jax.tree.map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.update([torch.from_numpy(g[n]) for n in t_params], torch.tensor(True))
        for n in params:
            np.testing.assert_allclose(t_params[n].numpy(), np.asarray(j_params[n]), rtol=2e-5, atol=1e-7,
                                       err_msg=n)
    assert int(opt.count) == len(grads) // accumulate


def test_weight_decay_mask_and_freeze_mask():
    params, grads = _opt_case()
    t_params = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    opt = AdamW(t_params.items(), OptimizerConfig(warmup_steps=0), frozen_prefixes=("dense",))
    decayed = dict(zip(opt.names, (float(v.flatten()[0]) for v in opt._views(opt._decayed))))
    assert decayed == {"dense.weight": 1.0, "dense.bias": 0.0, "ln.weight": 0.0, "pos_bias_u": 1.0,
                       "conv.weight": 1.0}
    assert freeze_mask(["dense.weight", "densely", "ln.weight"], ["dense"]) == {
        "dense.weight": False, "densely": True, "ln.weight": True}
    opt.update([torch.from_numpy(grads[0][n]) for n in t_params], torch.tensor(True))
    np.testing.assert_array_equal(t_params["dense.weight"].numpy(), params["dense.weight"])
    assert not np.array_equal(t_params["ln.weight"].numpy(), params["ln.weight"])


@pytest.mark.parametrize("case", ["large_norm", "nan"])
def test_guard_rejects_and_leaves_state_untouched(case):
    params, grads = _opt_case()
    model = torch.nn.ParameterDict({n.replace(".", "_"): torch.nn.Parameter(torch.from_numpy(v.copy()))
                                    for n, v in params.items()})
    opt = AdamW(model.named_parameters(), OptimizerConfig(warmup_steps=0, learning_rate=1e-2))
    state = TrainState.create_with_guards(model, opt, seed=0)
    names = list(params)
    gnorm, ok = state.apply_gradients_guarded([torch.from_numpy(grads[0][n]) for n in names], 100.0)
    assert bool(ok) and int(opt.count) == 1
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    mu, nu = opt.mu.clone(), opt.nu.clone()
    bad = [torch.from_numpy(grads[1][n]).clone() for n in names]
    if case == "nan":
        bad[0][0, 0] = float("nan")
    else:
        bad = [g * 100 for g in bad]
    gnorm, ok = state.apply_gradients_guarded(bad, 100.0)
    assert not bool(ok) and (case == "nan") == (not np.isfinite(float(gnorm)))
    assert state.step == 2 and int(opt.count) == 1
    assert int(state.skipped_steps) == 1 and int(state.nonfinite_steps) == (1 if case == "nan" else 0)
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    assert torch.equal(opt.mu, mu) and torch.equal(opt.nu, nu)


# ------------------------------------------------------------------ the trainer

def _batches(n, B=4, T=50, L=5, seed=0):
    rng = np.random.default_rng(seed)
    return [{
        "input_features": rng.standard_normal((B, T, 80)).astype(np.float32),
        "input_lengths": np.asarray([T, T - 7, T - 13, T - 20], np.int32),
        "labels": rng.integers(0, 30, (B, L)).astype(np.int32),
        "label_lengths": np.asarray([L, L - 1, L - 2, 1], np.int32),
    } for _ in range(n)]


OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


def _port_trainer(tree, cfg, **kw):
    model = EBranchformerForCTC(cfg)
    model.load_state_dict(state_dict_from_flax(tree, cfg), strict=True)
    tcfg = TrainerConfig(optimizer=OptimizerConfig(**OPT), spec_augment=None, **kw)
    return CTCTrainer(model, tcfg, device="cpu", dtype="float32")


def _fresh_trainer(tmp_path=None, **kw):
    cfg = EBranchformerConfig(**TINY)
    model = init_random_(EBranchformerForCTC(cfg), torch.Generator().manual_seed(0), matrix_std=cfg.initializer_range)
    tcfg = TrainerConfig(optimizer=OptimizerConfig(**OPT), checkpoint_dir=tmp_path and str(tmp_path), **kw)
    return CTCTrainer(model, tcfg, device="cpu", dtype="float32")


def test_trainer_overfits_a_fixed_batch_with_dropout_and_specaugment():
    trainer = _fresh_trainer()
    state = trainer.init_state()
    batch = _batches(1)[0]
    first = float(trainer.eval_step(state, batch)["loss"])
    for _ in range(6):
        state, m = trainer.train_step(state, batch)
        assert np.isfinite(float(m["loss"])) and int(m["step_applied"]) == 1
    assert float(trainer.eval_step(state, batch)["loss"]) < first


def test_eval_step_decodes():
    trainer = _fresh_trainer()
    out = trainer.eval_step(trainer.init_state(), _batches(1)[0])
    assert out["tokens"].shape[0] == 4 and out["token_lengths"].shape == (4,)
    assert np.isfinite(float(out["loss"]))


def test_checkpoint_restore_repeats_the_next_step(tmp_path):
    batches = _batches(4, seed=1)
    a = _fresh_trainer(tmp_path)
    sa = a.init_state()
    for b in batches[:2]:
        sa, _ = a.train_step(sa, b)
    a.save_checkpoint(sa)
    sa, ma = a.train_step(sa, batches[2])
    b_tr = _fresh_trainer(tmp_path)
    sb = b_tr.restore_checkpoint(b_tr.init_state())
    assert sb.step == 2 and int(sb.optimizer.count) == 2
    sb, mb = b_tr.train_step(sb, batches[2])
    assert float(ma["loss"]) == float(mb["loss"]) and float(ma["grad_norm"]) == float(mb["grad_norm"])
    for (n, p), (_, q) in zip(sa.model.named_parameters(), sb.model.named_parameters()):
        assert torch.equal(p, q), n


def test_fit_logs_evaluates_saves_and_prunes(tmp_path):
    trainer = _fresh_trainer(tmp_path, log_every=2, eval_every=2, save_every=1, keep_checkpoints=2,
                             max_steps=5)
    logger = MetricsLogger(str(tmp_path / "logs"))
    evals = []
    state = trainer.fit(
        trainer.init_state(), PrefetchIterator(iter(_batches(8)), depth=2, device_put=pinned_device_put("cpu")),
        eval_fn=lambda s: evals.append(s.step) or {"loss": float(trainer.eval_step(s, _batches(1)[0])["loss"])},
        hooks=[logger],
    )
    assert state.step == 5 and evals == [2, 4]
    assert checkpoint_steps(str(tmp_path)) == [4, 5]
    records = [json.loads(line) for line in open(logger.path)]
    assert [r["step"] for r in records] == [2, 2, 4, 4]
    assert records[0]["throughput"] > 0 and "eval/loss" in records[1]
    save_params(state.model, str(tmp_path / "final"))
    loaded = load_ctc_model(str(tmp_path / "final"), device="cpu")
    for (n, p), (_, q) in zip(state.model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(p, q), n


def test_early_stopping(tmp_path):
    trainer = _fresh_trainer(eval_every=1, early_stopping_patience=2, max_steps=10)
    state = trainer.fit(trainer.init_state(), iter(_batches(10)), eval_fn=lambda s: {"loss": float(s.step)})
    assert state.step == 3  # the metric worsens from the second evaluation on


def test_nan_postmortem_dump(tmp_path):
    trainer = _fresh_trainer(tmp_path, log_every=1, save_every=100)
    state = trainer.init_state()
    batch = _batches(1)[0]
    batch["input_features"][0, 0, 0] = np.nan
    state = trainer.fit(state, iter([batch]))
    assert int(state.nonfinite_steps) == 1 and int(state.optimizer.count) == 0
    assert os.path.exists(tmp_path / "nan_postmortem" / "state.pt")
    assert np.load(tmp_path / "nan_postmortem" / "batch.npz")["step"] == 1


def test_trainer_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CTCTrainer(EBranchformerForCTC(EBranchformerConfig(**TINY)))


# ------------------------------------------------------- bridge and host copies

def test_state_dict_round_trip_is_the_identity():
    _, pcfg, tree, _, _ = make_models(seed=5)
    back = flax_tree_from_state_dict(state_dict_from_flax(tree, pcfg), pcfg)
    a, b = dict(_flat(tree)), dict(_flat(back))
    assert set(a) == set(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_bucketing_copy_matches_jax_package():
    lengths = np.random.default_rng(0).integers(1000, 90000, 300)
    kw = dict(batch_size=16, num_length_groups=4, seed=3)
    ref = list(j_bucketing.BucketedBatchSampler(lengths, j_bucketing.BucketingConfig(**kw)).epoch_batches(2))
    got = list(bucketing.BucketedBatchSampler(lengths, bucketing.BucketingConfig(**kw)).epoch_batches(2))
    assert got == ref
    for n in (1, 1600, 1601, 50000):
        assert bucketing.quantize_length(n, bucketing.BucketingConfig()) == j_bucketing.quantize_length(
            n, j_bucketing.BucketingConfig())
    assert bucketing.quantize_length(700, bucketing.BucketingConfig(buckets=(500, 1000))) == 1000


class _CharTokenizer:
    def encode(self, text):
        return [ord(c) - 96 if c != " " else 27 for c in text]


def test_collator_copy_matches_jax_package():
    rng = np.random.default_rng(0)
    examples = [{"audio": {"array": rng.standard_normal(n).astype(np.float32)}, "text": t}
                for n, t in ((5000, "the fox"), (7300, "a dog jumps"), (1200, "to"))]
    ref = j_collator.SpeechCollator(j_collator.CollatorConfig(), _CharTokenizer())(examples)
    got = collator.SpeechCollator(collator.CollatorConfig(), _CharTokenizer())(examples)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype
    feats = [{"input_features": rng.standard_normal((n, 80)).astype(np.float32), "labels": [1, 2, 3][:m]}
             for n, m in ((90, 3), (140, 1))]
    ref = j_collator.FeatureCollator(j_collator.CollatorConfig(bucketing=j_bucketing.BucketingConfig(
        pad_to_multiple=100)))(feats)
    got = collator.FeatureCollator(collator.CollatorConfig(bucketing=bucketing.BucketingConfig(
        pad_to_multiple=100)))(feats)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_synthetic_speech_copy_matches_jax_package():
    text = j_speech.sample_sentence(np.random.default_rng(1))
    assert synthetic_speech.sample_sentence(np.random.default_rng(1)) == text
    np.testing.assert_array_equal(synthetic_speech.render_utterance(text, np.random.default_rng(2)),
                                  j_speech.render_utterance(text, np.random.default_rng(2)))
    wav, said = synthetic_speech.utterance(2.5, np.random.default_rng(3))
    assert wav.shape == (40000,) and wav.dtype == np.float32 and len(said) > 5


def test_metrics_copy_matches_jax_package():
    refs, hyps = ["the quick brown fox", "a dog"], ["the quick brown box jumps", "dog"]
    assert metrics.wer(refs, hyps) == j_metrics.wer(refs, hyps)
    assert metrics.cer(refs, hyps, detailed=True) == j_metrics.cer(refs, hyps, detailed=True)


def test_prefetch_iterator_propagates_errors_and_counts_audio():
    def source():
        yield {"input_values": np.zeros((2, 8), np.float32), "input_values_lengths": np.asarray([8, 5], np.int32)}
        raise ValueError("boom")

    it = PrefetchIterator(source(), depth=1, device_put=pinned_device_put("cpu"))
    first = next(it)
    assert isinstance(first["input_values"], torch.Tensor) and first["_num_audio_samples"] == 13
    with pytest.raises(ValueError, match="boom"):
        next(it)
