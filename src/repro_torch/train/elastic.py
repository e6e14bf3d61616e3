"""Elastic scaling + failure/straggler handling.

The port of the JAX package's ``train/elastic.py``. The policy:

  * node failure  -> the run dies; the launcher restarts it on the
    surviving slots. ``resume`` restores the latest checkpoint onto the
    new placement (checkpoints are logical; see checkpoint.py) and the
    deterministic-seek data source resumes at ckpt_step with no replay.
  * elastic remesh -> same path, deliberately: shrink/grow the slots.
  * straggler     -> Trainer's watchdog fires ``on_straggler``.

Slots are those of the port's ``launch/mesh.Mesh``: ``build(slots)``
returns the data-parallel step over a mesh of that many data slots
(``trainer.make_train_step`` of a model on the mesh) and the real
placements of its train state (``train/parallel.train_state_placements``),
onto which ``resume`` reshards the checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..launch.mesh import make_host_mesh
from .checkpoint import CheckpointManager

__all__ = ["resume", "ElasticRun"]


def resume(manager: CheckpointManager, abstract_state, placement=None):
    """Restore the latest checkpoint onto ``placement`` (a device, or a
    tree of placements: see ``CheckpointManager.restore``). Returns
    (state, step) or (None, 0) for a cold start."""
    step = manager.latest_step()
    if step is None:
        return None, 0
    state = manager.restore(step, abstract_state, placement)
    return state, step


@dataclasses.dataclass
class ElasticRun:
    """Drives Trainer across (simulated or real) failures and remeshes.

    ``build(slots)`` must return (step_fn, abstract_state, placement) for
    a slot count. ``device_schedule`` maps a step to the slot count from
    then on; its entry at 0 is the first, defaulting to the slots of
    ``make_host_mesh()`` (one per visible card)."""

    manager: CheckpointManager
    build: Callable[[int], tuple]
    init_state: Callable[[], Any]

    def run_with_failures(self, trainer_factory, total_steps: int,
                          failure_schedule: dict | None = None,
                          device_schedule: dict | None = None):
        failure_schedule = dict(failure_schedule or {})
        device_schedule = dict(device_schedule or {})
        devices = (device_schedule.pop(0) if 0 in device_schedule
                   else len(make_host_mesh().devices))
        step_fn, abstract_state, placement = self.build(devices)
        state, step = resume(self.manager, abstract_state, placement)
        if state is None:
            state, step = self.init_state(), 0
        attempts = 0
        while step < total_steps and attempts < 50:
            attempts += 1
            trainer = trainer_factory(step_fn)
            inject = failure_schedule.pop(step, None) if failure_schedule else None
            try:
                todo = total_steps - step
                if inject is not None:
                    todo = min(todo, max(inject - step, 1) + 5)
                state, _, step = trainer.run(
                    state, step, todo,
                    inject_failure_at=inject)
            except RuntimeError:
                # "node failure": restart, possibly on other slots
                if step in device_schedule or device_schedule:
                    devices = device_schedule.pop(
                        min(device_schedule), devices) if device_schedule else devices
                step_fn, abstract_state, placement = self.build(devices)
                state, step = resume(self.manager, abstract_state, placement)
                if state is None:
                    raise RuntimeError("failure before the first checkpoint")
        return state, step
