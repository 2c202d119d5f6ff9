"""Data parallelism of the port (``parallel/``, the trainers over a process
group) against one process and against the JAX trainers.

Two gloo ranks (``tests/torch_parallel_worker.py``, spawned with a
``file://`` rendezvous under ``tmp_path``) take one step of ``CTCTrainer``,
``BestRQTrainer``, ``JointTrainer`` and ``Wav2Vec2SSLTrainer`` on a global
batch of four rows, fp32, replicated and under ``fsdp``. Each is held against
the one-process port step on the whole batch (loss, gradient norm and the
weights after the step at rtol 1e-5 / atol 1e-7) and, but for wav2vec2
(``tests/test_torch_wav2vec2.py`` holds its objective against JAX), against
the JAX trainer's step on that batch over a two-device data mesh, from the
same initial weights (loss 1e-4, gradient norm 1e-3, weights 2e-3 / 2e-4 as
in ``tests/test_torch_training.py``). BEST-RQ's mask noise is one fixed draw
on all three sides. With SpecAugment and dropout on (CTC and joint, the
plain attention core; and CTC on the training attention kernel's plain
version with its in-kernel dropout), the two ranks equal one process: every
per-row draw is made for the global batch and sliced, and the kernel's
dropout hash numbers a rank's rows from its first row. The ranks also run the split and
the replicated evaluation, write and reload a sharded checkpoint, refuse a
batch they cannot split, and write a profiler trace.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as worker
from huggingface_asr_tpu.models.bestrq import BestRQForPreTraining as JBestRQ
from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel
from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig as JJoint
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder as JJointModel
from huggingface_asr_tpu.parallel.mesh import MeshConfig as JMeshConfig
from huggingface_asr_tpu.parallel.mesh import make_mesh as j_make_mesh
from huggingface_asr_tpu.training import loop as j_loop
from huggingface_asr_tpu.training import optim as j_optim

from huggingface_asr_tpu_torch.data.collator import CollatorConfig, SpeechCollator
from huggingface_asr_tpu_torch.interop.from_jax import (
    joint_state_dict_from_flax,
    pretraining_state_dict_from_flax,
    state_dict_from_flax,
)
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig
from huggingface_asr_tpu_torch.models.wav2vec2_ssl import Wav2Vec2ForPreTraining
from huggingface_asr_tpu_torch.ops.masking import compute_mask_indices, sample_negative_indices
from huggingface_asr_tpu_torch.parallel import mesh as mesh_module

NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, csgu_conv_dropout=0.0,
                  final_dropout=0.0)
ENC = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, conv_dim=(8, 8),
           conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1), vocab_size=30, attention_impl="xla")
RQ = dict(best_rq_codebook_size=64, best_rq_codebook_dim=8, best_rq_num_books=2, best_rq_in_dim=320)
W2V = dict(num_codevectors_per_group=16, num_codevector_groups=2, codevector_dim=16, proj_codevector_dim=16,
           num_negatives=4)
DEC = dict(vocab_size=30, n_positions=64, n_embd=32, n_layer=2, n_head=2, head_locations=(1,), head_weights=(0.3, 0.7),
           lsm_factor=0.1, bos_token_id=0, eos_token_id=1, pad_token_id=3)
DEC_NO_DROPOUT = dict(resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
DROPOUT = dict(hidden_dropout=0.1, attention_dropout=0.1, activation_dropout=0.1, csgu_conv_dropout=0.1,
               final_dropout=0.1)
B, T_MEL, T_ENC = 4, 100, 25
LENS = np.asarray([100, 93, 80, 61], np.int32)


def _ctc_batch(seed=0, rows=B):
    rng = np.random.default_rng(seed)
    return {"input_features": rng.standard_normal((rows, T_MEL, 80)).astype(np.float32),
            "input_lengths": LENS[:rows].copy(),
            "labels": rng.integers(4, 30, (rows, 6)).astype(np.int32),
            "label_lengths": np.asarray([6, 5, 3, 1][:rows], np.int32)}


def _ssl_batch(seed, negatives=False):
    rng = np.random.default_rng(seed)
    enc_lens = np.asarray([25, 23, 20, 15], np.int32)
    mask = compute_mask_indices((B, T_ENC), 0.5, 3, lengths=enc_lens, min_masks=2, rng=rng)
    batch = {"input_features": rng.standard_normal((B, T_MEL, 80)).astype(np.float32), "input_lengths": LENS.copy(),
             "mask_time_indices": mask}
    if negatives:
        batch["sampled_negative_indices"] = sample_negative_indices(mask, W2V["num_negatives"], rng=rng)
    return batch


def _jax_step(trainer, batch, patch_normal=None):
    """The JAX trainer's init tree, one step's loss and gradient norm, and the tree after it."""
    state = trainer.init_state(batch)
    tree = jax.tree.map(np.asarray, jax.device_get(state.params))
    real = jax.random.normal
    if patch_normal is not None:  # BEST-RQ's noise: the fixed draw where its shape asks for it
        jax.random.normal = lambda key, shape, dtype=jnp.float32: (
            jnp.asarray(patch_normal, dtype) if tuple(shape) == patch_normal.shape else real(key, shape, dtype))
    try:
        state, m = trainer.train_step(state, batch)
        m = {k: float(v) for k, v in jax.device_get(m).items()}
    finally:
        jax.random.normal = real
    return tree, m, jax.tree.map(np.asarray, jax.device_get(state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(cases, JAX results, one-process results, the two ranks' results)."""
    tmp = tmp_path_factory.mktemp("parallel")
    mesh = j_make_mesh(JMeshConfig(data=2), devices=jax.devices()[:2])
    tcfg = j_loop.TrainerConfig(optimizer=j_optim.OptimizerConfig(**worker.OPT), spec_augment=None)
    cases, jax_out = {}, {}

    enc = {**ENC, **NO_DROPOUT}
    batch = _ctc_batch()
    tree, m, final = _jax_step(j_loop.CTCTrainer(JModel(JConfig(**enc)), tcfg, mesh=mesh), batch)
    pcfg = EBranchformerConfig(**enc)
    cases["ctc"] = {"kind": "ctc", "config": enc, "state_dict": state_dict_from_flax(tree, pcfg), "batches": [batch]}
    jax_out["ctc"] = (m, state_dict_from_flax(final, pcfg))

    rq = {**enc, **RQ}
    batch = _ssl_batch(1)
    noise = np.random.default_rng(2).standard_normal((B, T_ENC, rq["hidden_size"])).astype(np.float32)
    trainer = j_loop.BestRQTrainer(JBestRQ(JConfig(**rq)), tcfg, mesh=mesh)
    tree, m, final = _jax_step(trainer, batch, patch_normal=noise)
    pcfg = EBranchformerConfig(**rq)
    buffers = jax.tree.map(np.asarray, jax.device_get(trainer.buffers))
    cases["bestrq"] = {"kind": "bestrq", "config": rq, "batches": [batch], "noise": noise,
                       "state_dict": pretraining_state_dict_from_flax({"params": tree, "buffers": buffers}, pcfg)}
    jax_out["bestrq"] = (m, pretraining_state_dict_from_flax({"params": final, "buffers": buffers}, pcfg))

    dec = {**DEC, **DEC_NO_DROPOUT}
    jcfg = JJoint(encoder=JConfig(**enc), decoder=JDec(**dec), ctc_weight=0.3)
    batch = _ctc_batch(3)
    batch["labels"][:, 0] = 0
    tree, m, final = _jax_step(j_loop.JointTrainer(JJointModel(jcfg), tcfg, mesh=mesh), batch)
    p_enc, p_dec = EBranchformerConfig(**enc), GPT2DecoderConfig(**dec)
    joint_cfg = {"encoder": enc, "decoder": dec, "ctc_weight": 0.3}
    cases["joint"] = {"kind": "joint", "config": joint_cfg, "batches": [batch],
                      "state_dict": joint_state_dict_from_flax(tree, p_enc, p_dec)}
    jax_out["joint"] = (m, joint_state_dict_from_flax(final, p_enc, p_dec))

    w2v = {**enc, **W2V}
    torch.manual_seed(0)
    cases["wav2vec2"] = {"kind": "wav2vec2", "config": w2v, "batches": [_ssl_batch(4, negatives=True)],
                         "state_dict": Wav2Vec2ForPreTraining(EBranchformerConfig(**w2v)).state_dict()}

    for name in list(cases):
        cases[f"{name}_fsdp"] = {**cases[name], "fsdp": True}
    # every per-row draw on: SpecAugment and dropout (the plain attention core)
    cases["ctc_draws"] = {**cases["ctc"], "config": {**ENC, **DROPOUT}, "spec_augment": True}
    cases["joint_draws"] = {**cases["joint"], "spec_augment": True,
                            "config": {**joint_cfg, "encoder": {**ENC, **DROPOUT}, "decoder": DEC}}
    # and the training attention kernel's in-kernel dropout (its plain version here)
    cases["ctc_k4_draws"] = {**cases["ctc_draws"], "config": {**ENC, **DROPOUT, "attention_impl": "pallas"}}

    spec = {"cases": cases, "eval_batches": {"split": _ctc_batch(5), "replicated": _ctc_batch(5, rows=3)},
            "odd_batch": _ctc_batch(6, rows=3)}
    torch.save(spec, tmp / "cases.pt")
    torch.multiprocessing.spawn(worker.rank_main, nprocs=2, args=(2, str(tmp / "pg"), str(tmp / "cases.pt"),
                                                                   str(tmp / "ranks.pt"), str(tmp / "work")))
    ranks = torch.load(tmp / "ranks.pt", weights_only=False)
    one = {name: worker.run_steps(case) for name, case in cases.items() if not case.get("fsdp")}
    one["eval"] = {name: worker.evaluate(cases["ctc"], b) for name, b in spec["eval_batches"].items()}
    return cases, jax_out, one, ranks


def _close(got, ref, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("name", ["ctc", "bestrq", "joint", "wav2vec2", "ctc_fsdp", "bestrq_fsdp", "joint_fsdp",
                                  "wav2vec2_fsdp", "ctc_draws", "joint_draws", "ctc_k4_draws"])
def test_two_ranks_equal_one_process(runs, name):
    """Loss, gradient norm, the other metrics and every weight after the step."""
    _, _, one, ranks = runs
    ref = one[name.replace("_fsdp", "")]
    got = ranks[name]
    assert got["steps"][0]["step_applied"] == 1
    if name.endswith("_draws"):  # the draws are on: the step is not the one without them
        assert ref["steps"][0]["loss"] != one[name[:-len("_draws")].replace("_k4", "")]["steps"][0]["loss"]
    if name == "ctc_k4_draws":  # the kernel's dropout, not the probabilities' elementwise one
        assert ref["steps"][0]["loss"] != one["ctc_draws"]["steps"][0]["loss"]
    for k, v in ref["steps"][0].items():
        _close(got["steps"][0][k], v, 1e-5, 1e-7, f"{name} {k}")
    for k, v in ref["params"].items():
        _close(got["params"][k], v, 1e-5, 1e-7, f"{name} {k}")


@pytest.mark.parametrize("name", ["ctc", "bestrq", "joint", "ctc_fsdp", "bestrq_fsdp", "joint_fsdp"])
def test_two_ranks_match_the_jax_trainer(runs, name):
    """BEST-RQ's loss / global num_masked and the decoder's global token mean
    included: loss within 1e-4, gradient norm within 1e-3, weights within
    2e-3 / 2e-4."""
    _, jax_out, _, ranks = runs
    j_metrics, j_final = jax_out[name.replace("_fsdp", "")]
    got = ranks[name]["steps"][0]
    _close(got["loss"], j_metrics["loss"], 1e-4, what="loss")
    _close(got["grad_norm"], j_metrics["grad_norm"], 1e-3, what="grad_norm")
    for k in ("num_masked", "enc_loss", "dec_loss"):
        if k in j_metrics:
            _close(got[k], j_metrics[k], 1e-4, what=k)
    for k, v in j_final.items():
        _close(ranks[name]["params"][k], v.numpy(), 2e-3, 2e-4, k)


def test_fsdp_shards_the_moments(runs):
    """Each rank holds a contiguous half of the flat moments; unsharded, all of them."""
    _, _, _, ranks = runs
    for name in ("ctc", "bestrq", "joint", "wav2vec2"):
        n = ranks[name]["n_params"]
        assert ranks[name]["mu_numel"] == n
        assert ranks[f"{name}_fsdp"]["mu_numel"] == -(-n // 2)


@pytest.mark.parametrize("which", ["split", "replicated"])
def test_split_and_replicated_evaluation_equal_one_process(runs, which):
    """Four rows split over the two ranks (loss summed, tokens gathered);
    three rows, which they do not divide, run whole on each rank."""
    _, _, one, ranks = runs
    ref, got = one["eval"][which], ranks["eval"][which]
    assert set(ref) == set(got)
    _close(got["loss"], ref["loss"], 1e-5, 1e-7, "loss")
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    np.testing.assert_array_equal(got["token_lengths"], ref["token_lengths"])


def test_rank_zero_checkpoint_loads_strictly(runs):
    """The sharded state, gathered and written by rank 0, restores whole
    (weights and moments); ``final/`` holds the model's keys."""
    _, _, _, ranks = runs
    ck = ranks["checkpoint"]
    assert ck["path"] is not None and os.path.exists(ck["path"])
    assert ck["restored_step"] == 1 and ck["restored_equal"] and ck["restored_mu_equal"]
    assert ck["final_keys_equal"]


def test_a_batch_the_ranks_cannot_split_raises(runs):
    _, _, _, ranks = runs
    assert ranks["odd_batch_error"] is not None and "divisible by the data-mesh size 2" in ranks["odd_batch_error"]


def test_profile_steps_writes_a_trace_per_rank(runs):
    _, _, _, ranks = runs
    assert ranks["profile_files"] == ["trace_rank0.json", "trace_rank1.json"]


def test_collating_a_ranks_rows_pads_them_as_the_global_batch():
    """``SpeechCollator(rows=...)``: the rows of the whole batch, padded to its
    length and label width, with ``_rows`` and every row's length."""
    rng = np.random.default_rng(0)
    examples = [{"audio": 0.1 * rng.standard_normal(n).astype(np.float32) + 0.5, "labels": list(range(k))}
                for n, k in ((16000, 3), (9000, 11), (12345, 2), (4000, 5))]
    collator = SpeechCollator(CollatorConfig())
    whole = collator(examples)
    part = collator(examples, rows=(2, 4))
    for k in ("input_values", "input_values_lengths", "labels", "label_lengths"):
        np.testing.assert_array_equal(part[k], whole[k][2:4])
    np.testing.assert_array_equal(part["_rows"], [2, 4, 4])
    np.testing.assert_array_equal(part["_all_lengths"], whole["input_values_lengths"])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_the_attention_kernels_keep_mask_numbers_a_ranks_rows_from_its_first_row(rate):
    """K4's dropout hash (its plain version) with ``row0``: a rank's rows of
    the global batch's keep-mask; inside a split step the model passes its
    first row."""
    from types import SimpleNamespace

    from huggingface_asr_tpu_torch.kernels.train_attention import keep_mask

    whole = keep_mask(4242, 6, 3, 40, rate)
    assert torch.equal(keep_mask(4242, 2, 3, 40, rate, row0=4), whole[4:6])
    assert not torch.equal(keep_mask(4242, 2, 3, 40, rate), whole[4:6])
    fake = SimpleNamespace(data=3, data_index=2, distributed=True)
    with mesh_module.Mesh.split(fake, 4, 6, 6):
        assert mesh_module.first_row() == 4
    assert mesh_module.first_row() == 0 and mesh_module.current_scope() is None
