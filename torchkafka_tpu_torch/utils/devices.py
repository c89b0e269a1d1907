"""The device rule every entry point of the port applies.

An entry point runs on CUDA unless its caller asks for the CPU by name
(``device="cpu"``, what the tests do). With no device given and no CUDA
present it raises: a serving or benchmark path that quietly carried on
on the CPU would report CPU numbers under a device's name.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → the current CUDA device, or ``RuntimeError`` without one;
    anything else → ``torch.device(device)`` (a CUDA device that is not
    present raises as well)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
