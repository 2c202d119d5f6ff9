"""PyTorch port, five ``CTCTrainer`` steps against the JAX trainer's on the
CPU (fp32, dropout and SpecAugment off, one initial state), then a batch
whose last row has no alignment and one with a block of all-zero frames
under the Flax init. The configs and helpers are those of
``tests/test_torch_training.py`` (split from it so that the two files run on
two workers).
"""

import numpy as np
import pytest

import jax

from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel
from huggingface_asr_tpu.parallel.mesh import MeshConfig, make_mesh
from huggingface_asr_tpu.training import loop as j_loop
from huggingface_asr_tpu.training import optim as j_optim
from test_torch_training import NO_DROPOUT, OPT, TINY, _batches, _flat, _port_trainer

from huggingface_asr_tpu_torch.interop.from_jax import flax_tree_from_state_dict
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig


@pytest.fixture(scope="module")
def jax_trainer_run():
    """Five steps of the JAX CTCTrainer (fp32, dropout and SpecAugment off) on
    one device, then one step on a batch whose last row has no alignment."""
    from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig

    jcfg = JConfig(**TINY, **NO_DROPOUT)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    tcfg = j_loop.TrainerConfig(optimizer=j_optim.OptimizerConfig(**OPT), spec_augment=None)
    trainer = j_loop.CTCTrainer(JModel(jcfg), tcfg, mesh=mesh)
    batches = _batches(5)
    state = trainer.init_state(batches[0])
    tree = jax.tree.map(np.asarray, jax.device_get(state.params))
    # the first step's gradient norm from the Flax init, with and without a
    # block of all-zero frames (what a SpecAugment time mask writes)
    zeroed = dict(batches[0])
    zeroed["input_features"] = zeroed["input_features"].copy()
    zeroed["input_features"][0, 8:32] = 0.0
    first_norms = [float(trainer.train_step(trainer.init_state(batches[0]), b)[1]["grad_norm"])
                   for b in (batches[0], zeroed)]
    losses, norms = [], []
    for b in batches:
        state, m = trainer.train_step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = jax.tree.map(np.asarray, jax.device_get(state.params))
    bad = dict(batches[0])
    bad["input_lengths"] = np.asarray([50, 43, 37, 4], np.int32)  # 1 frame for 1 label is fine ...
    bad["labels"] = bad["labels"].copy()
    bad["labels"][3] = 7
    bad["label_lengths"] = np.asarray([5, 4, 3, 5], np.int32)  # ... 5 repeated labels are not
    state, m = trainer.train_step(state, bad)
    verdict = {"step_applied": int(m["step_applied"]), "skipped_steps": int(m["skipped_steps"]),
               "loss": float(m["loss"])}
    return tree, final, losses, norms, bad, verdict, (zeroed, first_norms)


def test_five_trainer_steps_match_the_jax_trainer(jax_trainer_run):
    """Per-step loss and gradient norm within rtol 2e-3 (fp32 on both sides;
    differences compound through five AdamW updates), final parameters within 2e-3."""
    tree, final, j_losses, j_norms, _, _, _ = jax_trainer_run
    trainer = _port_trainer(tree, EBranchformerConfig(**TINY, **NO_DROPOUT))
    state = trainer.init_state()
    losses, norms = [], []
    for b in _batches(5):
        state, m = trainer.train_step(state, b)
        assert int(m["step_applied"]) == 1
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, j_losses, rtol=2e-3)
    np.testing.assert_allclose(norms, j_norms, rtol=2e-3)
    assert state.step == 5 and int(state.optimizer.count) == 5 and int(state.skipped_steps) == 0
    got = dict(_flat(flax_tree_from_state_dict(state.model.state_dict(), state.model.config)))
    for name, ref in _flat(final):
        np.testing.assert_allclose(got[name], ref, rtol=2e-3, atol=2e-4, err_msg=name)


def test_infeasible_batch_ends_where_the_jax_trainer_ends(jax_trainer_run):
    """A row with no alignment. The JAX loss stands 1e9 in for that row and
    its gradients stay finite, so its guard lets the step through; the port
    ends in the same place: a loss of 1e9 / (label length x batch) above the
    rest, the step applied, no counter bumped."""
    tree, _, _, _, bad, j_verdict, _ = jax_trainer_run
    assert j_verdict["step_applied"] == 1 and j_verdict["skipped_steps"] == 0
    trainer = _port_trainer(tree, EBranchformerConfig(**TINY, **NO_DROPOUT))
    state = trainer.init_state()
    state, m = trainer.train_step(state, bad)
    assert int(m["step_applied"]) == 1 and int(m["skipped_steps"]) == 0 and state.step == 1
    assert int(state.optimizer.count) == 1 and np.isfinite(float(m["grad_norm"]))
    np.testing.assert_allclose(float(m["loss"]), j_verdict["loss"], rtol=1e-5)
    assert float(m["loss"]) > 1e9 / (5 * 4)


def test_zero_frames_under_the_flax_init_inflate_the_gradient_norm_on_both_sides(jax_trainer_run):
    """The Flax init has zero conv biases, so an all-zero block of input frames
    reaches the feature projection's LayerNorm as constant rows, whose zero
    variance multiplies their gradient by rsqrt(eps). The JAX trainer's
    gradient norm grows by more than 10x on such a batch, and the port's
    equals it (rtol 1e-2): the guard's threshold of 100 is then within reach
    of one time mask on either side."""
    tree, _, _, _, _, _, (zeroed, (j_clean, j_zeroed)) = jax_trainer_run
    assert j_zeroed > 10.0 * j_clean
    trainer = _port_trainer(tree, EBranchformerConfig(**TINY, **NO_DROPOUT))
    _, m = trainer.train_step(trainer.init_state(), zeroed)
    np.testing.assert_allclose(float(m["grad_norm"]), j_zeroed, rtol=1e-2)
