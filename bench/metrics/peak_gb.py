"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), in GB."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx.get("peak_bytes") else None
