"""The share of the traced window in which no operation ran on the
device, in %."""


def read(ctx):
    w = ctx.trace.window_s
    return 100.0 * (w - ctx.trace.busy_s) / w if w > 0 else None
