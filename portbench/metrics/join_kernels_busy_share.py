"""join_kernels_busy_share (%): the join kernels' device time over the
device-busy time of the traced window. The kernels are K1-K6 of the port,
matched by these names in the trace."""

#: the join kernels of kernels/csrc/{lfvt_walk,bitmap_join,onehot_join}.cu
KERNELS = ("lfvt_walk_kernel", "lfvt_walk_planned_kernel",
           "bitmap_union_kernel", "bitmap_join_kernel", "onehot_join_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    mine = ctx.trace.kernel_seconds(KERNELS)
    busy = ctx.trace.busy_s
    if not mine or not busy:
        return None
    return 100.0 * mine / busy
