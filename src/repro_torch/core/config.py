"""Global configuration for the PyTorch port of the join stack.

The knobs the port reads, with the same names, defaults and
``REPRO_<FIELD>`` environment overrides as the JAX package's
``repro.core.config``, kept as a copy so the port imports nothing of
``repro``. Call sites read ``global_config`` at call time, so mutating
the singleton mid process takes effect on the next call.
"""
from __future__ import annotations

import os

__all__ = ["ConfigError", "GlobalConfig", "global_config",
           "GUARDRAIL_SHARE", "resolve_guardrail_budget"]

#: the share of a device's total memory that the guardrail's estimate
#: (4 B a dense cell) may reach before a task is split. The port's real
#: working set a cell is the bool mask (1 B) plus the pair buffer, so half
#: keeps the masks near an eighth of the card
GUARDRAIL_SHARE = 0.5


class ConfigError(ValueError):
    """A malformed ``REPRO_*`` environment override. Named (with the
    variable and the offending value in the message) because the
    singleton below parses the environment at *import time* — an
    anonymous ``int()``/``float()`` ValueError from deep inside
    ``GlobalConfig`` would otherwise be the first thing a user with
    ``REPRO_ROW_TILE=abc`` in their shell ever sees."""


class GlobalConfig:
    """Namespace of the join stack's tuning knobs (one mutable singleton)."""

    def __init__(self):
        ########## walk kernel (kernels/lfvt_walk.py) ##########
        # rows per CTA of the live row-tiled walk; one hot element
        # serializes its tile, not the block
        self.row_tile = 16
        # column padding multiple for count tiles / S-size rows
        self.col_pad = 128

        ########## pair emission (core/tile_join.py, kernels/ops.py) ##########
        # capacity grain of the power-of-two pair-buffer regrow protocol
        self.pair_cap_grain = 128
        # hard ceiling of the regrow protocol: round_capacity raises
        # PairCapacityError past it instead of silently allocating toward
        # the int32 pair-count limit
        self.pair_cap_ceiling = 1 << 27

        ########## single-device driver (core/tile_join.py) ##########
        self.r_block = 1024
        self.double_buffer = True

        ########## MapReduce driver (core/distributed.py) ##########
        # default shard padding mode: 'auto' resolves per path (bucket on
        # the loop and mesh-lfvt paths, global for the stacked-bitmap
        # mesh reduce)
        self.pad_mode = "auto"

        ########## resilience (core/resilience.py) ##########
        # bounded-retry policy for transient shard faults
        self.retry_max_attempts = 3
        self.retry_backoff_base = 0.05
        self.retry_backoff_cap = 1.0
        # backoff is computed+recorded, not slept, unless this is set
        # (tests stay wall-clock deterministic)
        self.retry_sleep = False
        # raise on empty R/S collections in the drivers (default: empty
        # inputs legally produce empty results)
        self.strict_validation = False
        # pre-dispatch memory guardrail: split a task whose estimated
        # dense (rows, cols) int32 working set exceeds the budget
        # (resilience path only). None: GUARDRAIL_SHARE of the total
        # memory of the device the task runs on, resolved at each call
        # (resolve_guardrail_budget); an int pins it in bytes. The
        # reference's counterpart is vmem_budget: at equal budgets the
        # task ids and guardrail_splits are the reference's
        self.memory_guardrail = True
        self.guardrail_budget = None
        # fault-injection plan ("site:kind[:count];..."; REPRO_FAULT) and
        # the seed for its deterministic corruptions
        self.fault = ""
        self.fault_seed = 0

        ########## dedup serving (serve/dedup.py) ##########
        # requests per padded walk micro-batch of the dedup serve engine
        self.serve_micro_batch = 16
        # pow-2 grain of the padded request lane width (Lr)
        self.serve_lane_grain = 8

        ########## cost-model planner (core/planner.py) ##########
        # rescale the per-family coefficients from the BENCH artifacts in
        # the working directory (planner.BENCH_GLOB); the embedded
        # defaults apply when no artifact parses
        self.planner_calibrate = True
        # Zipf head-mass probe: fraction of distinct elements counted as
        # the "head" (top-k by S-side frequency)
        self.planner_head_frac = 0.01

        self.update_from_env()

    def update_from_env(self, prefix: str = "REPRO_") -> None:
        """Override int/float/bool/str fields from ``<prefix><FIELD>`` vars.

        Raises :class:`ConfigError` (naming the variable and value) on a
        value that does not parse as the field's type — this runs at
        import, so the error message is the whole diagnostic.
        """
        for name, cur in vars(self).items():
            raw = os.environ.get(prefix + name.upper())
            if raw is None:
                continue
            try:
                if cur is None:     # an unset byte count (guardrail_budget)
                    setattr(self, name, int(raw))
                elif isinstance(cur, bool):
                    setattr(self, name,
                            raw.lower() in ("1", "true", "yes", "on"))
                elif isinstance(cur, float):
                    setattr(self, name, float(raw))
                elif isinstance(cur, int):
                    setattr(self, name, int(raw))
                else:
                    setattr(self, name, raw)
            except ValueError as e:
                kind = "int" if cur is None else type(cur).__name__
                raise ConfigError(
                    f"{prefix + name.upper()}={raw!r} is not a valid "
                    f"{kind} for config field {name!r} "
                    f"(default {cur!r})") from e

    def snapshot(self) -> dict:
        """Plain-dict view (bench metadata / test save-restore)."""
        return dict(vars(self))

    def restore(self, snap: dict) -> None:
        vars(self).update(snap)


global_config = GlobalConfig()


def resolve_guardrail_budget(device) -> int:
    """The guardrail's budget in bytes for a task on ``device``:
    ``global_config.guardrail_budget`` when set, else GUARDRAIL_SHARE of
    the device's total memory (a CUDA device's, the host's physical
    memory for any other). The total, not the free memory: a task's id
    carries its row span, so every process on one machine must cut a
    task the same way for a resumed run to find its checkpoints."""
    pinned = global_config.guardrail_budget
    if pinned is not None:
        return int(pinned)
    import torch  # deferred: the config module stays a leaf
    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return int(total * GUARDRAIL_SHARE)
