"""Training orchestration on one device (counterpart of
``huggingface_asr_tpu/training/loop.py``: ``TrainerConfig``, ``BaseTrainer``,
``CTCTrainer``).

One step is: log-mel featurization on the device (no gradient flows into it),
SpecAugment, the model's training forward in the trainer's compute dtype over
fp32 parameters, the fp32 CTC loss, backward, and the guarded optimizer update
(``training/train_state.py``). Nothing in a step waits for the device except
what the CTC loss itself copies to the host: the metrics come back as 0-d
device tensors and ``fit`` reads them only when it logs.

The per-step augment and dropout streams are derived from ``(seed, step)``, so
a restored run repeats the run it was saved from.

``JointTrainer`` trains the joint CTC/attention model (DeCRED/ED,
``models/joint_ctc_aed.py``): the same featurization and SpecAugment, the
joint forward with labels, ``enc_loss`` and ``dec_loss`` beside the loss.
The model holds fp32 weights (``param_dtype=torch.float32``) and computes in
the trainer's dtype.

``BestRQTrainer`` trains BEST-RQ pretraining (``models/bestrq.py``): the
masked frames' noise comes from the step's augment stream, the loss is divided
by the masked-frame count, and the frozen quantizer rides in the model's
buffers, so the checkpoint saves and restores it with the parameters.

``Wav2Vec2SSLTrainer`` trains wav2vec2 contrastive pretraining
(``models/wav2vec2_ssl.py``): the batches also carry
``sampled_negative_indices``, the Gumbel temperature decays a step, and the
Gumbel draws come from the step's augment stream.

``LLMASRTrainer`` trains LLM-ASR (``models/llm_asr.py``), reporting
``enc_loss`` where the model computes it; its evaluation decodes greedily
(``llm_asr_greedy_decode``, ``max_len`` the label rows' width).
``Seq2SeqTrainer`` trains the Whisper seq2seq model
(``models/whisper_seq2seq.py``) on its teacher-forced cross entropy. Both
models compute in their own ``dtype``, which must be the trainer's, as the
joint model's. ``CTCTrainer`` also trains the Whisper-encoder CTC model,
whose blank is its config's ``blank_token_id``.

The causal-LM trainer of ``cli/train_clm.py`` sits in that module, as in the
JAX package.

Every trainer runs over a ``parallel.mesh.Mesh`` (``TrainerConfig.mesh``):
one process alone, or one rank of a ``torch.distributed`` group (torchrun).
A rank computes its contiguous rows of each global batch (the batch already
cut by the collator, ``_rows``, or cut here) with the losses' denominators
and per-row draws of the global batch, and the optimizer sums the gradients
over the ``data`` ranks (``training/optim.py``; under ``fsdp`` it shards its
state). The model is not wrapped in ``DistributedDataParallel``: its
reducer hooks ``.grad`` accumulation, which ``torch.autograd.grad`` bypasses.
Evaluation splits the rows where the batch divides ``data`` and gathers the
outputs, else every rank runs the whole batch. Metrics come back summed
over the ranks; logs, hooks and checkpoint files come from rank 0.
``profile_steps`` > 0 captures steps ``[profile_start, profile_start +
profile_steps)`` with ``torch.profiler`` into ``profile_dir``
(``trace_rank<r>.json``, a Chrome trace).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from huggingface_asr_tpu_torch.models.configs import parse_dtype
from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng
from huggingface_asr_tpu_torch.ops.ctc import ctc_greedy_decode
from huggingface_asr_tpu_torch.ops.features import LogMelFrontEnd
from huggingface_asr_tpu_torch.ops.spec_augment import SpecAugmentConfig, spec_augment
from huggingface_asr_tpu_torch.parallel.distributed import host_barrier
from huggingface_asr_tpu_torch.parallel.mesh import Mesh, MeshConfig, global_rows, global_sum
from huggingface_asr_tpu_torch.training.model_factory import (
    load_trainer_checkpoint,
    save_trainer_checkpoint,
)
from huggingface_asr_tpu_torch.training.optim import AdamW, OptimizerConfig
from huggingface_asr_tpu_torch.training.train_state import TrainState
from huggingface_asr_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    mesh: MeshConfig = MeshConfig()
    spec_augment: Optional[SpecAugmentConfig] = SpecAugmentConfig()
    max_grad_norm_guard: float = 100.0
    log_every: int = 50
    eval_every: int = 1000
    save_every: int = 1000
    max_steps: int = 100_000
    seed: int = 42
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 5
    early_stopping_patience: int = 0  # 0 = disabled
    greater_is_better: bool = False
    metric_for_best: str = "eval_loss"
    # SpecAugment switches on at this global step.
    spec_augment_start_step: int = 0
    # wav2vec2 SSL (reference GumbelTemperatureCallback, callbacks.py:32-49)
    gumbel_temperature_start: float = 2.0
    gumbel_temperature_end: float = 0.5
    gumbel_temperature_decay: float = 0.999995
    # a torch.profiler capture of steps [profile_start, profile_start + profile_steps)
    profile_steps: int = 0
    profile_start: int = 10
    profile_dir: str = "torch_trace"


def _stream_seed(seed: int, step: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` (0 augment, 1 dropout) of ``step``."""
    x = (seed * 0x9E3779B97F4A7C15 + step * 0xC2B2AE3D27D4EB4F + stream * 0x165667B19E3779F9) & (2 ** 64 - 1)
    x ^= x >> 31
    x = (x * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    return (x ^ (x >> 29)) & (2 ** 63 - 1)


class BaseTrainer:
    """Shared mesh/optimizer/state/fit/checkpoint machinery.

    The trainer runs on the card unless the caller passes ``device="cpu"``;
    without a card the default raises. ``dtype`` is the compute dtype; the
    parameters stay fp32. ``mesh``: this rank's place in the process group
    (default: ``Mesh(config.mesh)``, one process alone where no group
    was joined). ``SHARED_METRICS``: the metrics that are each rank's share
    of a global sum, summed over the ranks with the loss."""

    SHARED_METRICS: Tuple[str, ...] = ()

    def __init__(
        self,
        model: nn.Module,
        config: TrainerConfig = TrainerConfig(),
        frontend: Optional[LogMelFrontEnd] = None,
        device: Union[str, torch.device] = "cuda",
        dtype: str = "bfloat16",
        frozen_prefixes=(),
        mesh: Optional[Mesh] = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).float()
        self.config = config
        self.frontend = frontend
        self.dtype = parse_dtype(dtype)
        self.frozen_prefixes = tuple(frozen_prefixes)
        self.mesh = mesh if mesh is not None else Mesh(config.mesh, self.device)

    # --------------------------------------------------------------- model fns
    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {
            k: v if k.startswith("_") else torch.as_tensor(v).to(self.device, non_blocking=True)
            for k, v in batch.items()
        }

    @torch.no_grad()
    def _featurize(self, batch: Dict[str, torch.Tensor]):
        """Waveform batches are featurized on the device inside the step."""
        if "input_features" in batch:
            return batch["input_features"], batch["input_lengths"]
        return self.frontend(batch["input_values"], batch["input_values_lengths"])

    def init_state(self) -> TrainState:
        """A fresh state over the model's current parameters."""
        optimizer = AdamW(self.model.named_parameters(), self.config.optimizer, self.frozen_prefixes, self.mesh)
        return TrainState.create_with_guards(self.model, optimizer, self.config.seed)

    # ------------------------------------------------------- subclass hooks
    def loss_and_metrics(self, batch, aug_gen, dropout_rng, step):
        raise NotImplementedError

    def eval_outputs(self, batch):
        raise NotImplementedError

    # ------------------------------------------------------------- step fns
    def step_streams(self, state: TrainState, step: Optional[int] = None):
        """The (augment generator, dropout stream) pair of ``step``."""
        step = state.step if step is None else step
        aug_gen = torch.Generator(device=self.device).manual_seed(_stream_seed(state.seed, step, 0))
        return aug_gen, DropoutRng(_stream_seed(state.seed, step, 1), self.device)

    def _local(self, batch: Dict[str, Any]):
        """(this rank's rows of ``batch`` on the device, ``(start, stop,
        total)`` or None where the process runs alone)."""
        batch = dict(batch)
        rows = batch.pop("_rows", None)
        batch.pop("_all_lengths", None)
        if rows is None and self.mesh.distributed:
            batch, rows = self.mesh.local_batch(batch)
        return self._to_device(batch), (None if rows is None else tuple(int(r) for r in rows))

    def _split(self, rows):
        return contextlib.nullcontext() if rows is None else self.mesh.split(*rows)

    def train_step(self, state: TrainState, batch: Dict[str, Any]):
        """One guarded optimizer step; updates ``state`` in place and returns
        it with the step's metrics (0-d tensors on the device). ``batch`` is
        the global batch, or this rank's rows of it with ``_rows``."""
        batch, rows = self._local(batch)
        aug_gen, dropout_rng = self.step_streams(state)
        self.model.train()
        with self._split(rows):
            loss, aux = self.loss_and_metrics(batch, aug_gen, dropout_rng, state.step)
        params = state.optimizer.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        gnorm, ok = state.apply_gradients_guarded(grads, self.config.max_grad_norm_guard)
        loss = loss.detach()
        if self.mesh.distributed:  # the ranks' shares of the global batch's loss and metrics
            keys = [k for k in self.SHARED_METRICS if k in aux]
            summed = self.mesh.all_reduce_(torch.stack([loss.float()] + [aux[k].float() for k in keys]))
            loss = summed[0]
            aux.update(zip(keys, summed[1:]))
        metrics = {
            "loss": loss,
            "grad_norm": gnorm,
            "step_applied": ok.to(torch.int32),
            "skipped_steps": state.skipped_steps.clone(),
            "nonfinite_steps": state.nonfinite_steps.clone(),
            **aux,
        }
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, Any]):
        """The evaluation outputs of the global ``batch``: split over the
        ``data`` ranks where its rows divide them (scalars summed, rows
        gathered), else the whole batch on every rank."""
        self.model.eval()
        n = len(next(v for k, v in batch.items() if not k.startswith("_")))
        if not self.mesh.distributed or n % self.mesh.data:
            return self.eval_outputs(self._to_device(batch))
        local, rows = self._local(batch)
        with self._split(rows):
            out = self.eval_outputs(local)
        return {k: self.mesh.all_reduce_(v.clone()) if v.ndim == 0 else self.mesh.gather_rows(v)
                for k, v in out.items()}

    # ------------------------------------------------------------------ loop
    def fit(
        self,
        state: TrainState,
        train_iter: Iterable[Dict[str, np.ndarray]],
        eval_fn: Optional[Callable[[TrainState], Dict[str, float]]] = None,
        hooks: Optional[Iterable[Callable[[int, Dict[str, Any]], None]]] = None,
    ) -> TrainState:
        cfg = self.config
        hooks = list(hooks or [])
        best_metric, best_step, patience_left = None, 0, cfg.early_stopping_patience
        t0 = time.time()
        audio_samples = 0
        nan_dumped = False
        primary = self.mesh.is_primary
        profiler = None

        for batch in train_iter:
            step = state.step
            if step >= cfg.max_steps:
                break
            if cfg.profile_steps > 0:
                if profiler is None and step == cfg.profile_start:
                    profiler = self._start_profiler()
                elif profiler is not None and step >= cfg.profile_start + cfg.profile_steps:
                    profiler = self._stop_profiler(profiler)
            batch = dict(batch)
            n_audio = batch.pop("_num_audio_samples", None)
            if n_audio is None:  # counted on the host copy, before it moves to the device
                for key in ("input_values_lengths", "input_lengths", "label_lengths"):
                    if key in batch and not (isinstance(batch[key], torch.Tensor) and batch[key].is_cuda):
                        n_audio = int(np.sum(np.asarray(batch[key])))
                        break
            state, metrics = self.train_step(state, batch)
            audio_samples += int(n_audio or 0)

            if (step + 1) % cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["throughput"] = audio_samples / max(time.time() - t0, 1e-6)
                if primary:
                    logger.info("step %d: %s", step + 1, m)
                    for h in hooks:
                        h(step + 1, m)
                # Post-mortem on the first non-finite gradient. The guard has
                # cancelled the update, so the parameters and optimizer state
                # are those before it; the batch is the logged step's, not
                # necessarily the offender's.
                if not nan_dumped and m.get("nonfinite_steps", 0) > 0 and cfg.checkpoint_dir:
                    nan_dumped = True
                    self._dump_nan_postmortem(state, batch, step + 1)

            if eval_fn is not None and (step + 1) % cfg.eval_every == 0:
                eval_metrics = eval_fn(state)
                if primary:
                    logger.info("eval @%d: %s", step + 1, eval_metrics)
                    for h in hooks:
                        h(step + 1, {f"eval/{k}": v for k, v in eval_metrics.items()})
                if cfg.early_stopping_patience > 0:
                    val = eval_metrics.get(cfg.metric_for_best.replace("eval_", ""))
                    if val is not None:
                        better = best_metric is None or (val > best_metric) == cfg.greater_is_better
                        if better:
                            best_metric, best_step = val, step + 1
                            patience_left = cfg.early_stopping_patience
                        else:
                            patience_left -= 1
                            if patience_left <= 0:
                                logger.info("early stop at %d (best %s=%s @%d)", step + 1,
                                            cfg.metric_for_best, best_metric, best_step)
                                break

            if cfg.checkpoint_dir and (step + 1) % cfg.save_every == 0:
                self.save_checkpoint(state)
        if profiler is not None:
            self._stop_profiler(profiler)
        return state

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """End the capture and write ``profile_dir/trace_rank<r>.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(self.config.profile_dir, f"trace_rank{self.mesh.rank}.json")
        profiler.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)

    def _dump_nan_postmortem(self, state: TrainState, batch, step: int):
        """Write parameters, optimizer state and the batch to
        ``<checkpoint_dir>/nan_postmortem/`` for offline diagnosis (rank 0;
        every rank takes part in gathering a sharded state)."""
        payload = self._payload(state)
        if not self.mesh.is_primary:
            return
        out = os.path.join(self.config.checkpoint_dir, "nan_postmortem")
        os.makedirs(out, exist_ok=True)
        torch.save(payload, os.path.join(out, "state.pt"))
        np.savez(os.path.join(out, "batch.npz"), step=np.asarray(step),
                 **{k: torch.as_tensor(v).cpu().numpy() for k, v in batch.items() if not k.startswith("_")})
        logger.warning("non-finite gradients: post-mortem dumped to %s", out)

    # ---------------------------------------------------------- checkpoints
    @staticmethod
    def _payload(state: TrainState) -> Dict[str, Any]:
        cpu = lambda t: t.detach().cpu()  # noqa: E731
        opt = state.optimizer.state_dict()
        return {
            "model": {k: cpu(v) for k, v in state.model.state_dict().items()},
            "optimizer": {k: {n: cpu(t) for n, t in v.items()} if isinstance(v, dict) else cpu(v)
                          for k, v in opt.items()},
            "step": state.step,
            "seed": state.seed,
            "skipped_steps": int(state.skipped_steps),
            "nonfinite_steps": int(state.nonfinite_steps),
        }

    def save_checkpoint(self, state: TrainState) -> Optional[str]:
        """``<checkpoint_dir>/checkpoint_<step>.pt``, written by rank 0 (a
        sharded optimizer state gathered whole first); the newest
        ``keep_checkpoints`` are kept. Returns the path (None on other ranks)."""
        payload = self._payload(state)
        path = None
        if self.mesh.is_primary:
            path = save_trainer_checkpoint(self.config.checkpoint_dir, state.step, payload,
                                           self.config.keep_checkpoints)
        host_barrier("checkpoint")
        return path

    def restore_checkpoint(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load the checkpoint of ``step`` (default: the newest) into ``state``."""
        saved = load_trainer_checkpoint(self.config.checkpoint_dir, step, map_location=self.device)
        state.model.load_state_dict(saved["model"], strict=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step, state.seed = int(saved["step"]), int(saved["seed"])
        state.skipped_steps.fill_(saved["skipped_steps"])
        state.nonfinite_steps.fill_(saved["nonfinite_steps"])
        return state

    def _maybe_spec_augment(self, aug_gen, feats, lengths, step: int):
        """SpecAugment inside the step, honouring delayed activation."""
        cfg = self.config
        if cfg.spec_augment is None or step < cfg.spec_augment_start_step:
            return feats
        return spec_augment(aug_gen, feats, lengths, cfg.spec_augment)


class CTCTrainer(BaseTrainer):
    """CTC encoder training over waveform or mel-feature batches."""

    def loss_and_metrics(self, batch, aug_gen, dropout_rng, step):
        feats, lengths = self._featurize(batch)
        feats = self._maybe_spec_augment(aug_gen, feats, lengths, step)
        out = self.model(feats.to(self.dtype), lengths, labels=batch["labels"],
                         label_lengths=batch["label_lengths"], rng=dropout_rng)
        return out.loss, {}

    def eval_outputs(self, batch):
        feats, lengths = self._featurize(batch)
        out = self.model(feats.to(self.dtype), lengths, labels=batch.get("labels"),
                         label_lengths=batch.get("label_lengths"))
        # blank = last index for the E-Branchformer family; Whisper-CTC models
        # carry an explicit blank_token_id
        blank = getattr(self.model.config, "blank_token_id", -1)
        tokens, token_lengths = ctc_greedy_decode(out.logits, out.logit_lengths, blank_id=blank)
        loss = out.loss if out.loss is not None else torch.zeros((), device=self.device)
        return {"loss": loss, "tokens": tokens, "token_lengths": token_lengths}


class _OwnDtypeTrainer(BaseTrainer):
    """A trainer of a model that computes in its own ``dtype``, which must be
    the trainer's."""

    def __init__(self, model, config: TrainerConfig = TrainerConfig(), frontend=None, device="cuda",
                 dtype: str = "bfloat16", frozen_prefixes=(), mesh: Optional[Mesh] = None):
        super().__init__(model, config, frontend, device, dtype, frozen_prefixes, mesh)
        if self.model.dtype != self.dtype:
            raise ValueError(f"the model computes in {self.model.dtype}, the trainer in {self.dtype}")

    def _forward(self, batch, aug_gen=None, dropout_rng=None, step=None):
        """The model on the batch's features (SpecAugmented in a training
        step, ``step`` given) with its labels where the batch has them."""
        feats, lengths = self._featurize(batch)
        if step is not None:
            feats = self._maybe_spec_augment(aug_gen, feats, lengths, step)
        return self.model(feats.to(self.dtype), lengths, labels=batch.get("labels"),
                          label_lengths=batch.get("label_lengths"), rng=dropout_rng)


class JointTrainer(_OwnDtypeTrainer):
    """DeCRED/ED training with the encoder's and the decoder's losses tracked
    (JAX ``JointTrainer``; reference AdditionalLossTrackerTrainer)."""

    SHARED_METRICS = ("enc_loss", "dec_loss")

    def loss_and_metrics(self, batch, aug_gen, dropout_rng, step):
        out = self._forward(batch, aug_gen, dropout_rng, step)
        return out.loss, {"enc_loss": out.enc_loss.detach(), "dec_loss": out.dec_loss.detach()}

    def eval_outputs(self, batch):
        out = self._forward(batch)
        return {"loss": out.loss, "enc_loss": out.enc_loss, "dec_loss": out.dec_loss}


class BestRQTrainer(BaseTrainer):
    """BEST-RQ pretraining (JAX ``BestRQTrainer``; reference SSLTrainer,
    training_utils.py:207-283): the loss divided by ``max(num_masked, 1)``,
    with ``num_masked`` and ``percent_masked`` as metrics. The batches carry
    ``mask_time_indices`` (B, T_enc) from the input pipeline
    (``cli/pretrain.py::make_ssl_batch_fn``). The quantizer's P and CB are
    buffers of the model: the optimizer never sees them, and ``_payload``'s
    state dict carries them through every checkpoint."""

    def _forward(self, batch, generator, rng):
        feats, lengths = self._featurize(batch)
        mask = batch["mask_time_indices"].to(torch.bool)
        out = self.model(feats, lengths, mask, generator=generator, rng=rng, dtype=self.dtype)
        num_masked = global_sum(out.num_masked)  # the global batch's, in a data-parallel step
        return num_masked, out.loss / torch.clamp(num_masked, min=1), mask

    def loss_and_metrics(self, batch, aug_gen, dropout_rng, step):
        num_masked, loss, mask = self._forward(batch, aug_gen, dropout_rng)
        num_masked = num_masked.float()
        frames = global_rows(mask.shape[0]) * mask.shape[1]
        return loss, {"num_masked": num_masked, "percent_masked": 100.0 * num_masked / frames}

    def eval_outputs(self, batch):
        # the noise of an evaluation step comes from a fixed seed, as the JAX trainer's key(0)
        generator = torch.Generator(device=self.device).manual_seed(0)
        return {"loss": self._forward(batch, generator, None)[1]}


class Wav2Vec2SSLTrainer(BaseTrainer):
    """wav2vec2 contrastive pretraining with a per-step Gumbel temperature
    decay (JAX ``Wav2Vec2SSLTrainer``). The batches carry
    ``mask_time_indices`` and ``sampled_negative_indices`` from the input
    pipeline (``cli/pretrain.py::make_ssl_batch_fn``); the step's Gumbel draws
    come from its augment generator, seeded from the trainer's seed and the
    step. The loss and the contrastive loss are divided by
    ``max(num_masked, 1)``."""

    def gumbel_temperature(self, step: int) -> float:
        """``max(start * decay ** step, end)`` in float32, as the JAX trainer computes it."""
        cfg = self.config
        t = np.float32(cfg.gumbel_temperature_start) * np.float32(cfg.gumbel_temperature_decay) ** np.float32(step)
        return float(max(t, np.float32(cfg.gumbel_temperature_end)))

    def _forward(self, batch, step: int, generator=None, rng=None):
        feats, lengths = self._featurize(batch)
        return self.model(feats, lengths, batch["mask_time_indices"].to(torch.bool),
                          batch["sampled_negative_indices"], gumbel_temperature=self.gumbel_temperature(step),
                          rng=rng, generator=generator, dtype=self.dtype)

    SHARED_METRICS = ("contrastive_loss",)

    def loss_and_metrics(self, batch, aug_gen, dropout_rng, step):
        out = self._forward(batch, step, aug_gen, dropout_rng)
        n = torch.clamp(global_sum(out.num_masked), min=1)
        return out.loss / n, {
            "contrastive_loss": out.contrastive_loss.detach() / n,
            "diversity_loss": out.diversity_loss.detach(),
            "codevector_perplexity": out.codevector_perplexity.detach(),
            "gumbel_temperature": torch.tensor(self.gumbel_temperature(step)),
        }

    def eval_outputs(self, batch):
        out = self._forward(batch, 0)
        return {"loss": out.loss / torch.clamp(global_sum(out.num_masked), min=1)}


class LLMASRTrainer(_OwnDtypeTrainer):
    """LLM-ASR training (JAX ``LLMASRTrainer``; the reference trains these
    through its CTC trainer with recipe-local models, local_models.py:10-243)."""

    SHARED_METRICS = ("enc_loss",)

    def loss_and_metrics(self, batch, aug_gen, dropout_rng, step):
        out = self._forward(batch, aug_gen, dropout_rng, step)
        return out.loss, ({} if out.enc_loss is None else {"enc_loss": out.enc_loss.detach()})

    def eval_outputs(self, batch):
        from huggingface_asr_tpu_torch.models.llm_asr import llm_asr_greedy_decode

        feats, lengths = self._featurize(batch)
        out = self.model(feats, lengths, labels=batch.get("labels"), label_lengths=batch.get("label_lengths"))
        max_len = batch["labels"].shape[1] if "labels" in batch else 48
        tokens, token_lengths = llm_asr_greedy_decode(self.model, feats, lengths, max_len=max_len)
        loss = out.loss if out.loss is not None else torch.zeros((), device=self.device)
        return {"loss": loss, "tokens": tokens, "token_lengths": token_lengths}


class Seq2SeqTrainer(_OwnDtypeTrainer):
    """Plain encoder-decoder cross-entropy training (JAX ``Seq2SeqTrainer``;
    the reference trains HF WhisperForConditionalGeneration directly,
    train_enc_dec_asr.py:82-85)."""

    def loss_and_metrics(self, batch, aug_gen, dropout_rng, step):
        return self._forward(batch, aug_gen, dropout_rng, step).loss, {}

    def eval_outputs(self, batch):
        return {"loss": self._forward(batch).loss}
