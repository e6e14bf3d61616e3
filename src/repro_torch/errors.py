"""Named errors of the PyTorch port that have no counterpart in ``repro``."""
from __future__ import annotations

__all__ = ["NotPortedError", "DeviceUnavailableError", "MeshTypeError",
           "NoBackwardError"]


class NotPortedError(ValueError):
    """The request needs a part of the JAX package that the PyTorch port
    does not have yet (a method family, a driver, a kwarg). The message
    names the part; ROADMAP.md lists when each one is due."""


class DeviceUnavailableError(RuntimeError):
    """A CUDA device was asked for (explicitly or by default) but torch
    sees none. The port never falls back to the CPU on its own: pass
    ``device="cpu"`` to run the plain PyTorch path."""


class MeshTypeError(TypeError):
    """``mesh=`` got an object that is not the port's
    ``repro_torch.launch.mesh.Mesh`` (a ``jax.sharding.Mesh``, say). The
    port never imports jax to look at it."""


class NoBackwardError(RuntimeError):
    """A kernel that has no backward was called where autograd would need
    one: grad mode on and an operand that requires grad. The flash
    attention kernel (K7) is inference only, as the reference's Pallas
    kernel is (``jax.grad`` through it raises); models train with
    ``attn_impl="jnp"``."""
