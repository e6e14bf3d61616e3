"""h2d_mb_per_op (MB): host-to-device copy bytes in the traced window, from
the profiler's copy events, per op: what staging each R batch and the
driver's per-block uploads cost."""


def read(ctx):
    if ctx.trace is None or not ctx.ops:
        return None
    moved = ctx.trace.copy_bytes.get("HtoD", 0)
    if not moved:
        return None
    return moved / len(ctx.ops) / 1e6
