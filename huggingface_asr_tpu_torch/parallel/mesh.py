"""Data parallelism over ``torch.distributed`` (counterpart of
``huggingface_asr_tpu/parallel/mesh.py``).

The JAX trainer runs one program over a mesh with a ``data`` and a ``model``
axis: the global batch's rows are split over ``data``, the parameters are
replicated or, under FSDP, sharded over ``data``, and XLA inserts the
collectives. Here a rank is one process (one GPU under torchrun) and
``Mesh`` holds its place in a ``DeviceMesh`` of world size ``data x model``:

- rows: rank ``(d, m)`` takes the ``d``-th contiguous ``1/data`` of every
  global batch; ranks that share ``d`` take the same rows, which is what the
  JAX program's replication over ``model`` computes;
- the trainer sums the flat gradient over the ``data`` group (all-reduce),
  or under ``fsdp`` reduce-scatters it, updates its own contiguous shard of
  the flat AdamW moments and master parameters, and all-gathers the
  parameters (``training/optim.py``);
- inside a split step (``Mesh.split``) the losses' denominators are global:
  ``global_rows`` (rows of a batch mean) and ``global_sum`` (token and
  masked-frame counts, and wav2vec2's code marginal, differentiably), so the
  sum of the ranks' losses is the global batch's loss and the sum of their
  gradients its gradient;
- per-row random draws (SpecAugment, dropout, BEST-RQ's noise, wav2vec2's
  Gumbel noise) go through ``row_draw``, which draws for the global batch
  and keeps the rank's rows, so N ranks repeat one process's draws; the
  training attention kernel's in-kernel dropout hash numbers the rank's
  rows from its first row of the global batch (``first_row``).

Without a process group the mesh is one rank and every collective is the
identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: every process left over by ``model``
    model: int = 1
    fsdp: bool = False  # shard the optimizer's flat state over ``data``
    # JAX leaves parameters below this size replicated; the port shards the
    # flat vectors as a whole, so every parameter is sharded (kept for the
    # JAX config's shape)
    fsdp_min_size: int = 2 ** 16


class Mesh:
    """This process's place in the ``(data, model)`` mesh, with the
    collectives the trainer needs over the ``data`` group."""

    def __init__(self, config: MeshConfig = MeshConfig(), device: Union[str, torch.device] = "cpu"):
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        model = max(1, config.model)
        data = config.data if config.data > 0 else world // model
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} != {world} processes")
        self.data, self.fsdp, self.rank = data, config.fsdp, rank
        self.data_index = rank // model
        self.group = None
        if dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh(torch.device(device).type, (data, model), mesh_dim_names=("data", "model"))
            self.group = mesh.get_group("data")

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    # ------------------------------------------------------------------ rows
    def rows(self, batch_size: int) -> Tuple[int, int]:
        """This rank's contiguous rows ``[start, stop)`` of a global batch."""
        if batch_size % self.data:
            raise ValueError(f"batch size {batch_size} must be divisible by the data-mesh size {self.data} "
                             f"(shard the global batch across devices)")
        n = batch_size // self.data
        return self.data_index * n, (self.data_index + 1) * n

    def local_batch(self, batch: Dict[str, Any]) -> Tuple[Dict[str, Any], Tuple[int, int, int]]:
        """A global batch's rows of this rank (keys that start with ``_``
        pass through; tensors copied, so the kernels get their own aligned
        buffers) and ``(start, stop, total)``."""
        total = len(next(v for k, v in batch.items() if not k.startswith("_")))
        start, stop = self.rows(total)
        rows = lambda v: v[start:stop].clone() if isinstance(v, torch.Tensor) else v[start:stop]  # noqa: E731
        return {k: v if k.startswith("_") else rows(v) for k, v in batch.items()}, (start, stop, total)

    @contextlib.contextmanager
    def split(self, start: int, stop: int, total: int):
        """Within: this rank computes rows ``[start, stop)`` of a global
        batch of ``total`` rows (global denominators, global draws)."""
        outer = current_scope()
        _STATE.scope = _RowScope(self, start, stop, total)
        try:
            yield
        finally:
            _STATE.scope = outer

    # ----------------------------------------------------------- collectives
    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ``data`` group, in place."""
        if self.distributed:
            dist.all_reduce(t, group=self.group)
        return t

    def shard_bounds(self, n: int) -> Tuple[int, int, int]:
        """``(lo, hi, n_pad)``: this rank's contiguous shard of a flat
        vector of ``n`` elements zero-padded to ``n_pad``, a multiple of ``data``."""
        size = -(-n // self.data)
        return self.data_index * size, (self.data_index + 1) * size, size * self.data

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the sum over the ``data`` group of ``flat``."""
        lo, hi, n_pad = self.shard_bounds(flat.numel())
        if not self.distributed:
            return flat[lo:hi]
        padded = torch.nn.functional.pad(flat, (0, n_pad - flat.numel()))
        out = torch.empty(hi - lo, dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(out, padded, group=self.group)
        return out

    def all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole padded flat vector from every rank's shard."""
        if not self.distributed:
            return shard
        out = torch.empty(shard.numel() * self.data, dtype=shard.dtype, device=shard.device)
        dist.all_gather_into_tensor(out, shard.contiguous(), group=self.group)
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' row blocks, concatenated in ``data`` order."""
        if not self.distributed:
            return t
        out = torch.empty((t.shape[0] * self.data,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out


@dataclasses.dataclass(frozen=True)
class _RowScope:
    mesh: Mesh
    start: int
    stop: int
    total: int


# The split step of this thread, set by ``Mesh.split`` around a forward (as
# autocast's state is): the model code below the trainer reads it without a
# mesh argument through every forward signature.
_STATE = threading.local()


def current_scope() -> Optional[_RowScope]:
    return getattr(_STATE, "scope", None)


def global_rows(n: int) -> int:
    """The global batch's row count where ``n`` is this rank's (a batch mean's denominator)."""
    scope = current_scope()
    return n if scope is None else n * scope.total // (scope.stop - scope.start)


def global_sum(x: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
    """``x`` summed over the ``data`` group inside a split step, else ``x``.
    ``differentiable``: the gradient flows back to every rank's ``x``."""
    scope = current_scope()
    if scope is None or not scope.mesh.distributed:
        return x
    if differentiable:
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(x, group=scope.mesh.group)
    return scope.mesh.all_reduce_(x.detach().clone())


def row_draw(fn: Callable[..., torch.Tensor], shape, **kwargs) -> torch.Tensor:
    """``fn(shape, **kwargs)`` (``torch.rand`` or ``torch.randn``) whose
    leading dimension runs over the batch's rows, batch-major. Inside a split
    step it draws for the whole global batch and keeps this rank's rows, so
    the draws are those of one process on the global batch."""
    scope = current_scope()
    if scope is None:
        return fn(shape, **kwargs)
    local = scope.stop - scope.start
    shape = tuple(shape)
    per_row, rest = divmod(shape[0], local)
    if rest:
        raise ValueError(f"a per-row draw of leading size {shape[0]} over {local} rows")
    full = fn((per_row * scope.total,) + shape[1:], **kwargs)
    return full[per_row * scope.start: per_row * scope.stop]


def first_row() -> int:
    """This rank's first row of the global batch inside a split step, else 0
    (the row number the training attention kernel's dropout hash starts at)."""
    scope = current_scope()
    return 0 if scope is None else scope.start
