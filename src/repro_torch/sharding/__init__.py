"""Sharding for the LM stack: logical-axis rules (``rules``), tensors
placed on mesh slots (``placed``) and the collectives over a mesh axis
(``collectives``)."""
from .collectives import (all_gather, all_reduce, all_to_all, counter,
                          reduce_scatter)
from .placed import Sharded, shard, unshard
from .rules import (DEFAULT_RULES, Placement, Rules, axis_size,
                    logical_to_spec, named_sharding, pad_to_multiple)

__all__ = ["DEFAULT_RULES", "Placement", "Rules", "Sharded", "all_gather",
           "all_reduce", "all_to_all", "axis_size", "counter",
           "logical_to_spec", "named_sharding", "pad_to_multiple",
           "reduce_scatter", "shard", "unshard"]
