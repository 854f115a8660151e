"""The whole event loop's share of the card's HBM bound: the least bytes
the window's event steps must move (``yardstick.event_step_bytes``: the
float64 remaining sizes read and written once and the allocation written
once, at each step's ``[C, M]``) at 3.35 TB/s, over the traced window.
Counted from shapes, so it reads the same work whatever implements the loop."""

from bench import yardstick


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    return yardstick.roofline_share(ctx["loop_bytes"], trace["window_s"])
