"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch

from ..errors import DeviceUnavailableError

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device. A CUDA device that torch
    cannot see raises :class:`DeviceUnavailableError`; the port never
    moves to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {str(dev)!r} requested but torch sees no CUDA device "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or "
                         "'cpu'")
    return dev
