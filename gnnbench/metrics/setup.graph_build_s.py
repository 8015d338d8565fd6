"""Seconds of the port's ``graph((src, dst), num_nodes=N)`` (the host
build: ``core/graph.py:_build``), host clock around the call."""


def read(ctx):
    return ctx.setup.get("graph_build_s")
