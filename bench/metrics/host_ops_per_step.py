"""Top-level aten ops the host dispatched in the traced window, over the
window's event steps (the event loop's launch stream, as the port's
``tools/torch_step_ops.py`` counts it)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx["steps"]:
        return None
    return trace["host_ops"] / ctx["steps"]
