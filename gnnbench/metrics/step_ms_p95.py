"""The 95th percentile (nearest rank) of every step's duration in the
window: CUDA events recorded between steps, read after the window."""
from gnnbench.harness import percentile


def read(ctx):
    return percentile(ctx.window.step_ms, 95.0)
