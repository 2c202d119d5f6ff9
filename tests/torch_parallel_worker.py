"""The ranks of ``tests/test_torch_parallel.py``: the port's trainers under a
``torch.distributed`` gloo group, with no JAX imported (each rank is a fresh
process).

A case is a dict: ``kind`` (ctc | bestrq | joint | wav2vec2), ``config`` (the
port config's fields), ``state_dict`` (the initial weights), ``batches``
(global batches of numpy arrays), ``spec_augment`` (bool), ``fsdp`` (bool) and
``noise`` (BEST-RQ's standard-normal mask noise of the global batch, or
None: the trainer draws it). ``run_steps`` runs one trainer over the batches
and returns each step's loss, gradient norm and metrics, the weights after
them and the size of the optimizer's first moment.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from huggingface_asr_tpu_torch.models import bestrq as port_bestrq
from huggingface_asr_tpu_torch.models.bestrq import BestRQForPreTraining
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig
from huggingface_asr_tpu_torch.models.joint_ctc_aed import JointCTCAttentionConfig
from huggingface_asr_tpu_torch.models.wav2vec2_ssl import Wav2Vec2ForPreTraining
from huggingface_asr_tpu_torch.ops.spec_augment import SpecAugmentConfig
from huggingface_asr_tpu_torch.parallel import mesh as mesh_module
from huggingface_asr_tpu_torch.parallel.mesh import MeshConfig
from huggingface_asr_tpu_torch.training.loop import (
    BestRQTrainer,
    CTCTrainer,
    JointTrainer,
    TrainerConfig,
    Wav2Vec2SSLTrainer,
)
from huggingface_asr_tpu_torch.training.model_factory import instantiate_aed_model, load_state
from huggingface_asr_tpu_torch.training.optim import OptimizerConfig

# Adam's first update is g / (|g| + eps) per entry. Where a gradient is
# rounding noise (zero in exact arithmetic, as the key bias's: the softmax
# does not see a constant added to every key), the sum of two ranks' halves
# and the whole batch's sum differ in that noise, which the default eps 1e-8
# turns into updates of up to lr apart. eps 1e-4 keeps the update a smooth
# function of the gradient there, so the weights after a step are held at the
# gradient's own precision.
OPT = dict(learning_rate=1e-3, lr_scheduler_type="constant", warmup_steps=0, total_steps=10, adam_epsilon=1e-4)


def build_trainer(case: Dict[str, Any], **config_kw):
    kind, cfg = case["kind"], case["config"]
    tcfg = TrainerConfig(optimizer=OptimizerConfig(**OPT),
                         spec_augment=SpecAugmentConfig() if case.get("spec_augment") else None,
                         mesh=MeshConfig(fsdp=case.get("fsdp", False)), **config_kw)
    if kind == "joint":
        config = JointCTCAttentionConfig(encoder=EBranchformerConfig(**cfg["encoder"]),
                                         decoder=GPT2DecoderConfig(**cfg["decoder"]), ctc_weight=cfg["ctc_weight"])
        model, _ = instantiate_aed_model(config, dtype=torch.float32)
        cls = JointTrainer
    else:
        model_cls, cls = {"ctc": (EBranchformerForCTC, CTCTrainer), "bestrq": (BestRQForPreTraining, BestRQTrainer),
                          "wav2vec2": (Wav2Vec2ForPreTraining, Wav2Vec2SSLTrainer)}[kind]
        model = model_cls(EBranchformerConfig(**cfg))
    model.load_state_dict(case["state_dict"], strict=True)
    return cls(model, tcfg, device="cpu", dtype="float32")


@contextlib.contextmanager
def fixed_noise(noise):
    """BEST-RQ's mask noise drawn as ``noise`` (the global batch's), this rank's rows of it."""
    if noise is None:
        yield
        return
    real = port_bestrq.row_draw

    def draw(fn, shape, **kwargs):
        scope = mesh_module.current_scope()
        z = torch.from_numpy(noise)
        return z if scope is None else z[scope.start:scope.stop]

    port_bestrq.row_draw = draw
    try:
        yield
    finally:
        port_bestrq.row_draw = real


def run_steps(case: Dict[str, Any]) -> Dict[str, Any]:
    trainer = build_trainer(case)
    state = trainer.init_state()
    steps = []
    with fixed_noise(case.get("noise")):
        for batch in case["batches"]:
            state, m = trainer.train_step(state, batch)
            steps.append({k: float(v) for k, v in m.items()})
    return {"steps": steps, "params": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            "mu_numel": state.optimizer.mu.numel(), "n_params": sum(p.numel() for p in state.optimizer.params)}


def evaluate(case: Dict[str, Any], batch) -> Dict[str, np.ndarray]:
    trainer = build_trainer(case)
    out = trainer.eval_step(trainer.init_state(), batch)
    return {k: v.cpu().numpy() for k, v in out.items()}


def rank_main(rank: int, world: int, init_file: str, cases_path: str, out_path: str, work_dir: str) -> None:
    """One rank: every case's steps, the evaluations, the checkpoints, the
    refused batch and the profiler capture; rank 0 saves what it saw."""
    torch.set_num_threads(1)  # tiny models; the suite's other workers share the cores
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    try:
        spec = torch.load(cases_path, weights_only=False)
        out: Dict[str, Any] = {name: run_steps(case) for name, case in spec["cases"].items()}
        out["eval"] = {name: evaluate(spec["cases"]["ctc"], batch) for name, batch in spec["eval_batches"].items()}

        # checkpoints of a sharded state, written by rank 0 and loaded whole
        ckpt = os.path.join(work_dir, "ckpt")
        trainer = build_trainer(spec["cases"]["ctc_fsdp"], checkpoint_dir=ckpt)
        state = trainer.init_state()
        state, _ = trainer.train_step(state, spec["cases"]["ctc_fsdp"]["batches"][0])
        path = trainer.save_checkpoint(state)
        from huggingface_asr_tpu_torch.cli.common import save_final

        final = save_final(trainer, work_dir)
        out["checkpoint"] = {"path": path, "final": final,
                             "params": {k: v.clone() for k, v in trainer.model.state_dict().items()},
                             "mu": {k: v.clone() for k, v in state.optimizer.state_dict()["mu"].items()}}
        fresh = build_trainer(spec["cases"]["ctc_fsdp"], checkpoint_dir=ckpt)
        restored = fresh.restore_checkpoint(fresh.init_state())
        out["checkpoint"]["restored_step"] = restored.step
        out["checkpoint"]["restored_equal"] = all(
            torch.equal(v, out["checkpoint"]["params"][k]) for k, v in fresh.model.state_dict().items())
        out["checkpoint"]["restored_mu_equal"] = all(
            torch.equal(v, out["checkpoint"]["mu"][k]) for k, v in restored.optimizer.state_dict()["mu"].items())
        out["checkpoint"]["final_keys_equal"] = set(load_state(final)) == set(trainer.model.state_dict())

        # a global batch that the two ranks cannot split
        try:
            build_trainer(spec["cases"]["ctc"]).train_step(state, spec["odd_batch"])
            out["odd_batch_error"] = None
        except ValueError as e:
            out["odd_batch_error"] = str(e)

        # the profiler's capture of step 0
        profile_dir = os.path.join(work_dir, "profile")
        trainer = build_trainer(spec["cases"]["ctc"], profile_steps=1, profile_start=0, profile_dir=profile_dir,
                                log_every=1)
        trainer.fit(trainer.init_state(), iter(spec["cases"]["ctc"]["batches"] * 2))
        out["profile_files"] = sorted(os.listdir(profile_dir))
        if rank == 0:
            torch.save(out, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()
