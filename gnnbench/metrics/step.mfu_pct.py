"""The whole step against the chip's peak: the least time of the step by
the count (``counts/<config>.py``'s ``step``: its dense products and edge
arithmetic at the float32 rate, or its compulsory bytes at the HBM rate,
whichever binds) over the traced window's time a step, in %."""


def read(ctx):
    least = ctx.least_ms("step")
    if least is None or ctx.steps <= 0:
        return None
    return 100.0 * least / (1e3 * ctx.trace.window_s / ctx.steps)
