"""Named errors of the PyTorch port that have no counterpart in ``repro``."""
from __future__ import annotations

__all__ = ["NotPortedError", "DeviceUnavailableError"]


class NotPortedError(ValueError):
    """The request needs a part of the JAX package that the PyTorch port
    does not have yet (a method family, a driver, a kwarg). The message
    names the part; ROADMAP.md lists when each one is due."""


class DeviceUnavailableError(RuntimeError):
    """A CUDA device was asked for (explicitly or by default) but torch
    sees none. The port never falls back to the CPU on its own: pass
    ``device="cpu"`` to run the plain PyTorch path."""
