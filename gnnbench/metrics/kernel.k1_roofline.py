"""gspmm's sums against their roofline: the least time of the step's
gspmm calls by the count (``counts/<config>.py``'s ``k1``: each call's
bytes at the HBM rate or its adds at the float32 rate, whichever binds),
over the device time of K1 and the hybrid's product a step, in %."""


def read(ctx):
    ms = ctx.trace.ms("k1") + ctx.trace.ms("gemm", "hybrid")
    least = ctx.least_ms("k1")
    if ms <= 0 or least is None:
        return None
    return 100.0 * least / (ms / ctx.steps)
