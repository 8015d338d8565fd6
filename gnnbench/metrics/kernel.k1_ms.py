"""Device milliseconds a step of gspmm's sums: K1 (``segment_sum``
kernels) and, on a graph with a dense-hub hybrid, its count-matrix
product."""


def read(ctx):
    ms = ctx.trace.ms("k1") + ctx.trace.ms("gemm", "hybrid")
    return ms / ctx.steps if ms > 0 else None
