"""Optimizer and learning-rate schedules (counterpart of
``huggingface_asr_tpu/training/optim.py``, which builds them from optax).

``AdamW`` here is optax's ``chain(clip_by_global_norm, adamw(mask = ndim > 1))``
written out, optionally under ``MultiSteps`` accumulation:

- clip: ``g / norm * max_norm`` where ``norm >= max_norm`` (optax's form; torch's
  ``clip_grad_norm_`` divides by ``norm + 1e-6``);
- Adam moments with bias correction, ``eps`` outside the square root;
- decoupled weight decay on parameters with more than one dimension
  (matrices, conv kernels and the (H, dh) position biases; not biases or
  LayerNorm parameters);
- the learning rate of the step is ``schedule(count)`` with ``count`` the
  number of updates applied so far, so the first update has rate 0 under a
  warm-up from 0.

Every quantity of an update, the count included, lives on the parameters'
device, and ``update(grads, apply)`` selects between the updated and the old
values with a 0-d bool tensor, so a trainer can reject a step without a host
round trip. Parameters and state are updated in place.

Under a data-parallel ``Mesh`` (``parallel/mesh.py``) the flat gradient is
summed over the ``data`` ranks (``reduce_gradients``). With ``fsdp`` each rank
holds a contiguous ``1/data`` shard of the flat moments (and accumulator): the
gradient is reduce-scattered, the rank updates its shard of the flat fp32
parameters and all-gathers the whole vector back into the parameters. The
numbers are the unsharded update's; the global norm is ``sqrt`` of the summed
squares in both layouts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from huggingface_asr_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-3
    lr_scheduler_type: str = "linear"  # linear | cosine | constant | inverse_sqrt
    warmup_steps: int = 5000
    total_steps: int = 100_000
    weight_decay: float = 1e-6
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 5.0
    gradient_accumulation_steps: int = 1


def make_schedule(config: OptimizerConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """``schedule(count)`` for a 0-d tensor (or a number): linear warm-up from
    0 over ``warmup_steps``, then the decay, whose own count restarts at the
    boundary (``optax.join_schedules``)."""
    lr, W = config.learning_rate, config.warmup_steps
    decay_steps = max(config.total_steps - W, 1)
    kind = config.lr_scheduler_type
    if kind not in ("linear", "cosine", "constant", "inverse_sqrt"):
        raise ValueError(kind)

    def decay(c: torch.Tensor) -> torch.Tensor:
        if kind == "linear":
            return lr * (1.0 - torch.clamp(c / decay_steps, 0.0, 1.0))
        if kind == "cosine":
            return lr * 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(c, max=decay_steps) / decay_steps))
        if kind == "constant":
            return torch.full_like(c, lr)
        return lr * torch.sqrt(W / torch.clamp(c + W, min=1.0))

    def schedule(count) -> torch.Tensor:
        c = torch.as_tensor(count).to(torch.float32)
        # a warm-up of no steps is the constant 0 and is never selected
        warm = lr * torch.clamp(c / W, 0.0, 1.0) if W > 0 else torch.zeros_like(c)
        return torch.where(c < W, warm, decay(c - W))

    return schedule


def decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """No weight decay for biases, LayerNorm parameters or any other 1-D parameter."""
    return {name: p.ndim > 1 for name, p in named_params}


def freeze_mask(names: Iterable[str], frozen_prefixes: Sequence[str]) -> Dict[str, bool]:
    """Trainability by parameter name: False where the dotted name equals a
    frozen prefix or starts with it (e.g. ``wav2vec2.encoder``)."""
    return {
        n: not any(n == p or n.startswith(p + ".") for p in frozen_prefixes) for n in names
    }


class AdamW:
    """State is kept flat (one fp32 vector each for the two moments and the
    accumulator, in parameter order), so an update is a few large tensor
    operations and one ``_foreach_add_`` into the parameters. Under an
    ``fsdp`` mesh those vectors are this rank's shard."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], config: OptimizerConfig,
                 frozen_prefixes: Sequence[str] = (), mesh: Optional[Mesh] = None):
        named = list(named_params)
        self.config = config
        self.names = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.schedule = make_schedule(config)
        self.mesh = mesh
        self.sharded = mesh is not None and mesh.fsdp
        dev = self.params[0].device
        self._sizes = [p.numel() for p in self.params]
        n = sum(self._sizes)
        lo, hi, n_pad = mesh.shard_bounds(n) if self.sharded else (0, n, n)
        self._shard = slice(lo, hi)
        trainable, decayed = freeze_mask(self.names, frozen_prefixes), decay_mask(named)
        per_param = lambda flags: torch.cat([  # noqa: E731
            torch.full((p.numel(),), float(flags[nm]), device=dev) for nm, p in named]
            + [torch.zeros(n_pad - n, device=dev)])[lo:hi]
        self._trainable, self._decayed = per_param(trainable), per_param(decayed)
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.mu = torch.zeros(hi - lo, device=dev)
        self.nu = torch.zeros(hi - lo, device=dev)
        self.k = config.gradient_accumulation_steps
        if self.k > 1:
            self.mini_step = torch.zeros((), dtype=torch.int64, device=dev)
            self.acc = torch.zeros(hi - lo, device=dev)

    def reduce_gradients(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The flat fp32 gradient summed over the ``data`` ranks: whole, or
        this rank's shard under ``fsdp``."""
        g = torch.cat([x.reshape(-1).to(torch.float32) for x in grads])
        if self.mesh is None:
            return g
        return self.mesh.reduce_scatter(g) if self.sharded else self.mesh.all_reduce_(g)

    def global_norm(self, g: torch.Tensor) -> torch.Tensor:
        """The L2 norm of the whole flat gradient from ``reduce_gradients``' output."""
        sq = torch.sum(g * g)
        if self.sharded:
            self.mesh.all_reduce_(sq)
        return torch.sqrt(sq)

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [v.view_as(p) for v, p in zip(flat.split(self._sizes), self.params)]

    @torch.no_grad()
    def update(self, grads: Union[Sequence[torch.Tensor], torch.Tensor], apply: torch.Tensor) -> None:
        """One optimizer call on ``grads`` (one per parameter, or the flat
        output of ``reduce_gradients``). Where ``apply`` (0-d bool tensor) is
        false nothing changes: parameters, moments, count and accumulator
        keep their values."""
        cfg = self.config
        g = grads if isinstance(grads, torch.Tensor) else self.reduce_gradients(grads)
        emit = apply
        if self.k > 1:
            step = self.mini_step
            g = self.acc + (g - self.acc) / (step + 1).to(torch.float32)
            last = step == self.k - 1
            emit = apply & last
            self.acc.copy_(torch.where(apply, torch.where(last, torch.zeros_like(g), g), self.acc))
            self.mini_step.copy_(torch.where(apply, torch.where(last, 0, step + 1), step))
        norm = self.global_norm(g)
        g = torch.where(norm >= cfg.max_grad_norm, g / norm * cfg.max_grad_norm, g)
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        t = (self.count + 1).to(torch.float32)
        mu = b1 * self.mu + (1.0 - b1) * g
        nu = b2 * self.nu + (1.0 - b2) * g * g
        u = (mu / (1.0 - b1 ** t)) / (torch.sqrt(nu / (1.0 - b2 ** t)) + cfg.adam_epsilon)
        p = torch.cat([x.reshape(-1) for x in self.params])[self._shard]  # the master parameters of this rank's shard
        if p.numel() < u.numel():  # the last shard's padding
            p = torch.nn.functional.pad(p, (0, u.numel() - p.numel()))
        u = u + cfg.weight_decay * self._decayed * p
        step_size = self.schedule(self.count) * self._trainable
        self.mu.copy_(torch.where(emit, mu, self.mu))
        self.nu.copy_(torch.where(emit, nu, self.nu))
        delta = torch.where(emit, -step_size * u, torch.zeros_like(u))
        if self.sharded:
            whole = self.mesh.all_gather(p + delta)[:sum(self._sizes)]
            torch._foreach_copy_(self.params, self._views(whole))
        else:
            torch._foreach_add_(self.params, self._views(delta))
        self.count.add_(emit.to(torch.int64))

    def _whole(self, flat: torch.Tensor) -> torch.Tensor:
        """A flat state vector in full: gathered from every rank under ``fsdp``."""
        return self.mesh.all_gather(flat)[:sum(self._sizes)] if self.sharded else flat

    def state_dict(self) -> Dict[str, object]:
        """Moments by parameter name, and the counts; whole under ``fsdp``
        too (every rank must call it: the shards are gathered)."""
        state = {"count": self.count, "mu": dict(zip(self.names, self._views(self._whole(self.mu)))),
                 "nu": dict(zip(self.names, self._views(self._whole(self.nu))))}
        if self.k > 1:
            state["mini_step"] = self.mini_step
            state["acc"] = dict(zip(self.names, self._views(self._whole(self.acc))))
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """From a whole state (``state_dict``'s layout); under ``fsdp`` each
        rank keeps its shard."""
        self.count.copy_(state["count"])
        flats = {"mu": self.mu, "nu": self.nu}
        if self.k > 1:
            flats["acc"] = self.acc
            self.mini_step.copy_(state["mini_step"])
        for key, flat in flats.items():
            whole = torch.cat([torch.as_tensor(state[key][name]).reshape(-1).to(flat.device, torch.float32)
                               for name in self.names])
            whole = torch.nn.functional.pad(whole, (0, max(0, self._shard.stop - whole.numel())))
            flat.copy_(whole[self._shard])
