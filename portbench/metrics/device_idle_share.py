"""device_idle_share (%): the share of the traced window in which no
device event ran, 1 - (the union of the device events' intervals) / (the
window). It moves r_sets_per_s: the card waits on the host's per-op work."""
from portbench.yardstick import idle_share


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return idle_share(ctx.trace.busy_s, ctx.trace.window_s)
