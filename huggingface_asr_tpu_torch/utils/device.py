"""Device choice of the port's entry points.

Every entry point runs on the card by default and raises when there is none;
the CPU is used only where the caller asks for it (``device="cpu"``).
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested (the default) but CUDA is not available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device
