"""The allocate's host time a step: the total of the ``engine.allocate``
spans (the fused kernel's launch, or the rank policy's ops) over the counter
``engine.steps``, in us."""

from bench import program_spans


def read(ctx):
    v = program_spans.per_step(ctx, "engine.allocate", "total_s")
    return None if v is None else v * 1e6
