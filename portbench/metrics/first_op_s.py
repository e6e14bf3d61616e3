"""first_op_s (s): the wall time of the run's first join, against the fresh
S, which stages S on the card (the LFVT encode and upload, or the bitmap
sheet and its compressed words): the part of set-up that the program does."""


def read(ctx):
    return ctx.spans.get("first_op_s")
