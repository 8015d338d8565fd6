"""Seconds of ``prepare_spmm(g, device=...)`` (the graph's copy to the
card, K1's row plans, the dense-hub hybrid), host clock around the call
and a synchronize."""


def read(ctx):
    return ctx.setup.get("prepare_s")
