"""Device milliseconds a step of the GAT edge phase: K2 (``gat_fwd``),
K3 (``gat_bwd``) and K1's sum of the logits' dst gradient (``der``; in a
GAT step K1 runs nowhere else)."""


def read(ctx):
    ms = ctx.trace.ms("k2") + ctx.trace.ms("k3") + ctx.trace.ms("k1")
    return ms / ctx.steps if ms > 0 else None
