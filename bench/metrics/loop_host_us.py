"""The event loop's own host time a step: the self time of the
``engine.loop`` spans (their total less the ``engine.allocate`` spans inside)
over the counter ``engine.steps``, in us.  It includes time blocked on a
full launch queue, so it follows the device's pace where the device paces
the loop, and the dispatch cost where the host does."""

from bench import program_spans


def read(ctx):
    v = program_spans.per_step(ctx, "engine.loop", "self_s")
    return None if v is None else v * 1e6
