"""Seconds from the start of the process to the first timed step:
imports, generation, ``graph``, ``prepare_spmm``, the kernels' load (and
build, in a checkout's first run), the model and its first steps."""


def read(ctx):
    return ctx.setup["setup_s"]
