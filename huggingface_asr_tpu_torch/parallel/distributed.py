"""Process-group set-up (counterpart of ``huggingface_asr_tpu/parallel/distributed.py``).

The port runs one process per GPU, launched by ``torchrun``, which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.
``initialize_distributed`` joins the process group from that environment:
NCCL with the process bound to ``cuda:LOCAL_RANK`` on the card, gloo on the
CPU. A process started without that environment runs alone, and the call
is a no-op there.

    torchrun --nproc_per_node 4 -m huggingface_asr_tpu_torch.cli.train_ctc ... [--fsdp]
"""

from __future__ import annotations

import logging
import os
from typing import Union

import torch
import torch.distributed as dist

from huggingface_asr_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def initialize_distributed(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this rank's device: ``cuda:LOCAL_RANK`` (NCCL) where ``device``
    is the card, the CPU (gloo) where it is ``"cpu"``. Without that
    environment, or with the group already joined, it only resolves
    ``device``. A card that is missing raises, as everywhere in the port."""
    device = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    if device.type == "cuda":
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    logger.info("process group joined: rank %d of %d (%s, %s)", dist.get_rank(), dist.get_world_size(),
                dist.get_backend(), device)
    return device


def host_barrier(tag: str = "barrier") -> None:
    """Every rank waits here for the others (no-op when running alone)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        logger.debug("barrier %s", tag)
        dist.barrier()


def is_primary() -> bool:
    """Rank 0, or a process running alone."""
    return not dist.is_initialized() or dist.get_rank() == 0
