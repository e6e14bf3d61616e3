"""Global configuration for the PyTorch port of the join stack.

The knobs the port reads, with the same names, defaults and
``REPRO_<FIELD>`` environment overrides as the JAX package's
``repro.core.config``, kept as a copy so the port imports nothing of
``repro``. Call sites read ``global_config`` at call time, so mutating
the singleton mid process takes effect on the next call.
"""
from __future__ import annotations

import os

__all__ = ["ConfigError", "GlobalConfig", "global_config"]


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
        # default shard padding mode: 'auto' resolves to 'bucket' on the
        # loop path
        self.pad_mode = "auto"

        ########## resilience (core/resilience.py) ##########
        # bounded-retry policy for transient shard faults
        self.retry_max_attempts = 3
        self.retry_backoff_base = 0.05
        self.retry_backoff_cap = 1.0
        # backoff is computed+recorded, not slept, unless this is set
        # (tests stay wall-clock deterministic)
        self.retry_sleep = False
        # pre-dispatch memory guardrail: split a task whose estimated
        # dense (rows, cols) int32 working set exceeds guardrail_budget
        # bytes (resilience path only). The budget is the reference's
        # vmem_budget (a TPU core's 16 MiB), kept so that task ids and
        # guardrail_splits equal the reference's
        self.memory_guardrail = True
        self.guardrail_budget = 16 * 2 ** 20
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
                if isinstance(cur, bool):
                    setattr(self, name,
                            raw.lower() in ("1", "true", "yes", "on"))
                elif isinstance(cur, float):
                    setattr(self, name, float(raw))
                elif isinstance(cur, int):
                    setattr(self, name, int(raw))
                else:
                    setattr(self, name, raw)
            except ValueError as e:
                raise ConfigError(
                    f"{prefix + name.upper()}={raw!r} is not a valid "
                    f"{type(cur).__name__} for config field {name!r} "
                    f"(default {cur!r})") from e


global_config = GlobalConfig()
