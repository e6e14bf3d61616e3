"""Carry the JAX package's model weights across to the port.

``params_from_reference(jax.tree.map(np.asarray, params))`` turns the
reference's parameter tree, as numpy arrays, into the port's nested dict
of tensors with the same keys; ``train_state_from_reference`` does the
same for a whole train state (params, and the optimizer's int32 step,
float32 master weights and moments). bfloat16 arrays (``ml_dtypes.bfloat16``
in numpy, found by the dtype's name, so nothing here imports
``ml_dtypes``) move bit for bit through a uint16 view.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .params import tree_map

__all__ = ["params_from_reference", "train_state_from_reference"]


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr)    # a writable copy: torch.from_numpy shares memory
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_reference(tree, device=None) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays) as
    tensors on ``device`` (default: the first CUDA device), same keys,
    same values bit for bit."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a).to(dev), tree)


def train_state_from_reference(tree, device=None) -> dict:
    """The reference's train state ``{"params", "opt": {"step", "master",
    "m", "v"}}`` (nested dicts of numpy arrays) as the port's, on
    ``device`` (default: the first CUDA device), bit for bit."""
    if sorted(tree) != ["opt", "params"] or sorted(tree["opt"]) != [
            "m", "master", "step", "v"]:
        raise ValueError("a train state is {'params', 'opt': {'step', "
                         "'master', 'm', 'v'}}")
    state = params_from_reference(tree, device)
    state["opt"]["step"] = state["opt"]["step"].to(torch.int32)
    return state
