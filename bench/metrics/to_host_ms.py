"""The host's wait for the device at a grid's end (span ``sweep.to_host``:
the results' copy to the host, which drains the device's queue) a grid: its
total over the count of ``sweep`` spans, in ms."""

from bench import program_spans


def read(ctx):
    v = program_spans.per_grid(ctx, "sweep.to_host")
    return None if v is None else v * 1e3
