"""Bisection steps of the water-fill a step: the counter
``policy.waterfill_iters`` (a ``waterfill`` call's steps, whatever its
rows) over the counter ``engine.steps``.  None where the window recorded
either nothing."""

from bench import program_spans


def read(ctx):
    snap = program_spans.window(ctx)
    if snap is None:
        return None
    iters = snap["counters"].get("policy.waterfill_iters")
    steps = snap["counters"].get("engine.steps")
    return iters / steps if iters and steps else None
