"""join_kernels_roofline (%): the sum of the least times of the join
kernels' launches in the traced window over their measured device time.

Each op's driver blocks (``r_block`` R rows each, in the op's order) are
one launch each of the family its method runs; ``portbench.roofline``
counts each launch's bound from the R rows, S and the pairs the op
returned. The measured time is that of the family's kernels, matched by
these names. A method whose family is not listed is left out of both
sums."""
import numpy as np

from portbench import roofline

#: method -> (family counted, the kernels that do its work)
FAMILIES = {
    "lfvt": ("walk", ("lfvt_walk_kernel",)),
    "popcount": ("popcount", ("bitmap_union_kernel", "bitmap_join_kernel")),
    "kernel_bitmap": ("popcount", ("bitmap_union_kernel",
                                   "bitmap_join_kernel")),
    "onehot": ("onehot", ("onehot_join_kernel",)),
    "kernel_onehot": ("onehot", ("onehot_join_kernel",)),
}


def read(ctx):
    if ctx.trace is None or not ctx.ops:
        return None
    s = roofline.SortedS(*ctx.s, ctx.cfg["universe"])
    r_off, r_val = ctx.pool
    bound, kernels, words = 0.0, set(), None
    for op in ctx.ops:
        fam = FAMILIES.get(op["stats"].get("method"))
        if fam is None:
            continue
        family, names = fam
        if family == "popcount" and words is None:
            words = s.words(ctx.device)
        kernels.update(names)
        rows = op["rows"]
        block = op["stats"]["plan"]["r_block"]
        pos = np.empty(len(r_off) - 1, np.int64)
        pos[rows] = np.arange(len(rows))
        per_block = np.bincount(pos[op["pair_r"]] // block,
                                minlength=-(-len(rows) // block))
        for k in range(0, len(rows), block):
            got = roofline.block_bounds(family, r_off, r_val,
                                        rows[k:k + block],
                                        int(per_block[k // block]), s,
                                        ctx.threshold, ctx.device, words)
            bound += got[0]
    measured = ctx.trace.kernel_seconds(tuple(kernels)) if kernels else 0.0
    if not bound or not measured:
        return None
    return 100.0 * bound / measured
