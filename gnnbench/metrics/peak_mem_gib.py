"""``torch.cuda.max_memory_allocated()`` over set-up and window, GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
