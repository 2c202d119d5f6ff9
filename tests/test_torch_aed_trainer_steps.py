"""PyTorch port, three ``JointTrainer`` steps against the JAX trainer's on
the CPU: from one initial state (fp32, every dropout rate 0, no
SpecAugment), per-step losses and gradient norms, the evaluation after them
and the final parameters. The configs and helpers are those of
``tests/test_torch_aed_training.py`` (split from it so that the two files
run on two workers).
"""

import numpy as np
import pytest
import torch

import jax

from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder as JModel
from huggingface_asr_tpu.parallel.mesh import MeshConfig, make_mesh
from huggingface_asr_tpu.training import loop as j_loop
from huggingface_asr_tpu.training import optim as j_optim
from test_torch_aed_training import _flat, _joint_configs

from huggingface_asr_tpu_torch.interop.from_jax import joint_flax_tree_from_state_dict, joint_state_dict_from_flax
from huggingface_asr_tpu_torch.training.loop import JointTrainer, TrainerConfig
from huggingface_asr_tpu_torch.training.model_factory import instantiate_aed_model
from huggingface_asr_tpu_torch.training.optim import OptimizerConfig

OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


def _trainer_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(4, 40, (3, 8)).astype(np.int32)
        labels[:, 0] = 0
        out.append({"input_features": rng.standard_normal((3, 64, 80)).astype(np.float32),
                    "input_lengths": np.asarray([64, 57, 41], np.int32), "labels": labels,
                    "label_lengths": np.asarray([8, 6, 4], np.int32)})
    return out


@pytest.fixture(scope="module")
def jax_joint_trainer_run():
    """Three steps of the JAX JointTrainer (fp32, dropout and SpecAugment off)
    on one device from its own init."""
    jcfg, _ = _joint_configs()
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    tcfg = j_loop.TrainerConfig(optimizer=j_optim.OptimizerConfig(**OPT), spec_augment=None)
    trainer = j_loop.JointTrainer(JModel(jcfg), tcfg, mesh=mesh)
    batches = _trainer_batches(3)
    state = trainer.init_state(batches[0])
    tree = jax.tree.map(np.asarray, jax.device_get(state.params))
    logged = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        logged.append({k: float(m[k]) for k in ("loss", "enc_loss", "dec_loss", "grad_norm")})
    ev = jax.device_get(trainer.eval_step(state.params, batches[0]))
    final = jax.tree.map(np.asarray, jax.device_get(state.params))
    return tree, logged, {k: float(ev[k]) for k in ("loss", "enc_loss", "dec_loss")}, final


def test_three_joint_trainer_steps_match_the_jax_trainer(jax_joint_trainer_run):
    """Per-step loss, enc_loss, dec_loss and gradient norm within rtol 2e-3,
    the evaluation outputs after them too, and the final parameters within
    2e-3 / 2e-4 (the tolerances of CTCTrainer's comparison)."""
    tree, j_logged, j_eval, j_final = jax_joint_trainer_run
    _, pcfg = _joint_configs()
    model, _ = instantiate_aed_model(pcfg, dtype=torch.float32)
    model.load_state_dict(joint_state_dict_from_flax(tree, pcfg.encoder, pcfg.decoder), strict=True)
    trainer = JointTrainer(model, TrainerConfig(optimizer=OptimizerConfig(**OPT), spec_augment=None), device="cpu",
                           dtype="float32")
    state = trainer.init_state()
    for b, ref in zip(_trainer_batches(3), j_logged):
        state, m = trainer.train_step(state, b)
        assert int(m["step_applied"]) == 1
        for k, v in ref.items():
            np.testing.assert_allclose(float(m[k]), v, rtol=2e-3, err_msg=k)
    ev = trainer.eval_step(state, _trainer_batches(1)[0])
    for k, v in j_eval.items():
        np.testing.assert_allclose(float(ev[k]), v, rtol=2e-3, err_msg=k)
    got = dict(_flat(joint_flax_tree_from_state_dict(state.model.state_dict(), pcfg.encoder, pcfg.decoder)))
    for name, ref in _flat(j_final):
        np.testing.assert_allclose(got[name], ref, rtol=2e-3, atol=2e-4, err_msg=name)
