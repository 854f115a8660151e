"""Device kernels in the traced window (copies and fills left out), over
the window's event steps."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx["steps"]:
        return None
    return trace["kernels"] / ctx["steps"]
