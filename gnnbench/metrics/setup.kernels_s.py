"""Seconds to load the port's kernel library (``ops/cuda/build.py``
``library``), host clock around the call: in a checkout's first run it
also builds the library with nvcc (the line's ``setup.kernels_built``
says so), and every later run loads it from ``build/``."""


def read(ctx):
    return ctx.setup.get("kernels_s")
