"""Device milliseconds a step in the nn layers' dense products (cuBLAS
kernels launched under ``aten::linear`` or its backward; the dense-hub
hybrid's count-matrix product is gspmm's, ``trace.gemm_role``)."""


def read(ctx):
    ms = ctx.trace.ms("gemm", "nn")
    return ms / ctx.steps if ms > 0 else None
