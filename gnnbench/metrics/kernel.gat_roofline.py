"""The GAT edge phase against its roofline: the least time of each
layer's edge phase forward and backward by the count
(``counts/<config>.py``'s ``gat``), over the device time of K2, K3 and
K1's der sum a step, in %."""


def read(ctx):
    ms = ctx.trace.ms("k2") + ctx.trace.ms("k3") + ctx.trace.ms("k1")
    least = ctx.least_ms("gat")
    if ms <= 0 or least is None:
        return None
    return 100.0 * least / (ms / ctx.steps)
