"""Device resolution for the port's entry points, and host uploads."""
from __future__ import annotations

import numpy as np
import torch

from ..errors import DeviceUnavailableError

__all__ = ["resolve_device", "upload"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device. A CUDA device that torch
    cannot see raises :class:`DeviceUnavailableError`; the port never
    moves to the CPU unless the caller asks for it. ``"meta"`` (shapes
    only, nothing allocated) serves a dry run's abstract tensors."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {str(dev)!r} requested but torch sees no CUDA device "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda', "
                         "'cpu' or 'meta'")
    return dev


def upload(x: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To a GPU it goes through
    pinned memory with ``non_blocking=True``, so the host does not wait
    for the device's queue (the copy stays ordered on the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
