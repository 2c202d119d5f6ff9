"""Train state with gradient-anomaly accounting (counterpart of
``huggingface_asr_tpu/training/train_state.py``).

A step whose global gradient norm is not finite, or is at or above a
threshold, is cancelled: the parameters and the whole optimizer state, its
update count included, stay as they were, while ``step`` still advances. So
the learning-rate schedule follows the applied steps and the per-step random
streams follow all steps. The decision is a 0-d bool tensor on the device
(``torch.where`` inside the optimizer), with no host round trip; the two
counters are device tensors too.

Unlike the Flax state this one is mutable: the model's parameters and the
optimizer's buffers are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from huggingface_asr_tpu_torch.training.optim import AdamW


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: AdamW
    seed: int  # the per-step augment and dropout streams derive from (seed, step)
    step: int = 0
    skipped_steps: torch.Tensor = None  # rejected by the guard, for any reason
    nonfinite_steps: torch.Tensor = None  # rejected because the norm was NaN or Inf

    @classmethod
    def create_with_guards(cls, model: nn.Module, optimizer: AdamW, seed: int) -> "TrainState":
        dev = optimizer.count.device
        zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
        return cls(model=model, optimizer=optimizer, seed=seed, skipped_steps=zero(),
                   nonfinite_steps=zero())

    def apply_gradients_guarded(self, grads, max_grad_norm_guard: float = 100.0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply ``grads`` (one per optimizer parameter, this rank's under a
        data-parallel mesh: they are summed over the ranks first) unless their
        global norm, taken before any clipping, is anomalous. Returns
        ``(grad_norm, applied)`` as 0-d tensors."""
        g = self.optimizer.reduce_gradients(grads)
        gnorm = self.optimizer.global_norm(g)
        finite = torch.isfinite(gnorm)
        ok = finite & (gnorm < max_grad_norm_guard)
        self.optimizer.update(g, ok)
        self.step += 1
        self.skipped_steps += (~ok).to(torch.int32)
        self.nonfinite_steps += (~finite).to(torch.int32)
        return gnorm, ok
