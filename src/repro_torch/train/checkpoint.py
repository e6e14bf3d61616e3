"""Atomic checkpoints with keep-k and async save, placed on load.

The port of the JAX package's ``train/checkpoint.py``, with its on-disk
layout unchanged, so a checkpoint written by either package restores in
the other::

    <dir>/step_<N:08d>/arrays.npz + meta.json      (tmp dir + rename)

``arrays.npz`` maps each leaf's path (dict keys in sorted order, the
order ``jax.tree`` flattens a dict in, joined by ``//``) to its logical
content as a numpy array; bfloat16, which numpy cannot store, is kept as
its uint16 bit pattern under the key plus ``::bf16``. ``meta.json``
holds the step and the sorted keys. A state placed on a mesh (leaves
``sharding.Sharded``) is saved whole, so the layout stays logical;
placement is applied on load, to whatever device or mesh the restarting
job has (``restore(..., placements)`` reshards).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from ..core.device import resolve_device
from ..sharding.placed import Sharded, shard, unshard
from ..sharding.rules import Placement

__all__ = ["CheckpointManager"]

_SEP = "//"
_BF16 = "::bf16"  # numpy cannot serialize bfloat16; store as uint16 view


def _map_paths(fn, tree, prefix=()):
    """``fn(path, leaf)`` over a nested dict's leaves, keys in sorted order
    (a path is the tuple of keys down to the leaf), in its structure."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, tree[k], prefix + (str(k),))
                for k in sorted(tree)}
    return fn(prefix, tree)


def _host(t: torch.Tensor) -> tuple[str, np.ndarray]:
    """A leaf's key suffix and its host copy: a copy even of a CPU tensor,
    which ``.cpu()`` would share, since the train step updates the state
    in place while an async save writes."""
    if isinstance(t, Sharded):
        t = unshard(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return _BF16, t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    return "", t.to("cpu", copy=True).numpy()


def _flatten(tree) -> dict:
    out = {}

    def put(path, leaf):
        suffix, arr = _host(leaf)
        out[_SEP.join(path) + suffix] = arr
    _map_paths(put, tree)
    return out


def _tensor(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if bf16 else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ #
    def save(self, step: int, state) -> None:
        arrays = _flatten(state)  # host copy happens on the caller thread
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays), daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, arrays: dict) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "keys": sorted(arrays)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------ #
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target, placement=None):
        """Rebuild ``target``-structured state from step ``step``'s arrays,
        in the dtypes stored. ``target``'s leaves give the structure and
        shapes and may be ``meta`` tensors (see
        ``trainer.abstract_train_state``). ``placement`` is a device for
        every leaf, or a tree of ``target``'s structure whose leaves are
        each a ``Placement`` (the leaf is cut into its pieces on that
        mesh: resharded onto the restart's mesh), a device, or None;
        where it gives none, a leaf goes to its target leaf's device, or
        to the first CUDA device for a ``meta`` leaf. A shape that
        differs from the target's raises ``ValueError``."""
        path = os.path.join(self.directory, f"step_{step:08d}", "arrays.npz")
        per_leaf = isinstance(placement, dict)
        fixed = (None if placement is None or per_leaf
                 else resolve_device(placement))
        with np.load(path) as data:
            def load(keys, leaf, where=None):
                key = _SEP.join(keys)
                bf16 = key + _BF16 in data
                t = _tensor(data[key + _BF16] if bf16 else data[key], bf16)
                if tuple(t.shape) != tuple(leaf.shape):
                    raise ValueError(f"checkpoint step {step}: {key} has "
                                     f"shape {tuple(t.shape)}, the target "
                                     f"{tuple(leaf.shape)}")
                if isinstance(where, Placement):
                    return shard(t, where)
                if where is not None:
                    return t.to(resolve_device(where))
                dev = fixed or (resolve_device(None) if _is_meta(leaf)
                                else _device(leaf))
                return t.to(dev)
            if per_leaf:
                return _map_paths2(load, target, placement)
            return _map_paths(load, target)


def _is_meta(leaf) -> bool:
    return (leaf.shards[0].is_meta if isinstance(leaf, Sharded)
            else leaf.is_meta)


def _device(leaf):
    return leaf.shards[0].device if isinstance(leaf, Sharded) else leaf.device


def _map_paths2(fn, tree, other, prefix=()):
    """``_map_paths`` over ``tree`` with ``other``'s leaf at each path."""
    if isinstance(tree, dict):
        return {k: _map_paths2(fn, tree[k], other[k], prefix + (str(k),))
                for k in sorted(tree)}
    return fn(prefix, tree, other)
