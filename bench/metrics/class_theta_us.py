"""The class-aware policy's host time a step: the total of the
``multiclass.theta`` spans (``class_theta`` inside ``class_rule``: on the
water-filling cell its bisection of the water level) over the counter
``engine.steps``, in us."""

from bench import program_spans


def read(ctx):
    v = program_spans.per_step(ctx, "multiclass.theta", "total_s")
    return None if v is None else v * 1e6
