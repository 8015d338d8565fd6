"""Milliseconds a training step: the whole window, from before the first
step to the synchronize that ends it, over the steps completed in it."""


def read(ctx):
    return 1e3 * ctx.window.wall_s / ctx.window.steps
