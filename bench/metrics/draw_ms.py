"""The host time of the tapes' draw (span ``sweep.draw``: the per-seed
``SeedSequence`` spawns, the samplers, the stacking) a grid: its total over
the count of ``sweep`` spans, in ms."""

from bench import program_spans


def read(ctx):
    v = program_spans.per_grid(ctx, "sweep.draw")
    return None if v is None else v * 1e3
