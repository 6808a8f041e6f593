"""Device resolution shared by the public entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  Without a card, anything but an explicit
    CPU device raises: nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so a host
    clock around it measures the work, not its enqueueing."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
